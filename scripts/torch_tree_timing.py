"""SD seconds of a few ``chip_smoke.py`` runs for two checkouts, in one call.

Each checkout runs in its own process, in the order a, b, b, a (``--pairs``
times), so that both see the same card and host: lands at batch 1 and 16,
pgp2like at 64, the LP master on lands (MASTER_TYPE 0) and one warm
evaluation batch of 512 stormlike lanes.  Every run goes through that
checkout's own ``chip_smoke.run_fields`` and package; each process prints
one JSON line (the checkout, the SD seconds, pivots per LP and kernel
launches of each run, and the evaluation batch's seconds), then the card as
nvidia-smi gives it.  Compare two commits with a copy of the other one
unpacked beside this checkout (``git archive``):

    python3 scripts/torch_tree_timing.py --a other_checkout --b .
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, os, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from stochasticdecomposition_torch.config import MASTER_LP, SDConfig
from stochasticdecomposition_torch.core.evaluate import make_eval_batch
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_torch.sampler import sample_omega
from stochasticdecomposition_torch.ops import kernels
kernels.build()
kernels.library()
dev = torch.device("cuda")
runs = {"lands": ("lands", SDConfig(EVAL_FLAG=False), False),
        "lands_b16": ("lands", cs.batched_cfg("lands", 16), True),
        "pgp2like_b64": ("pgp2like", cs.batched_cfg("pgp2like", 64), True),
        "lands_lp": ("lands", SDConfig(EVAL_FLAG=False, MASTER_TYPE=MASTER_LP,
                                       MAX_ITER=cs.LP_ITERS,
                                       **cs.DEFAULT_CAPS), True)}
out = {"root": root}
for tag, (name, cfg, via_run) in runs.items():
    cfg.EVAL_FLAG = False
    fields = cs.run_fields(name, dev, cfg, via_run=via_run, exact=False)[0]
    out[tag] = {k: fields[k] for k in ("sd_seconds", "pivots_per_lp",
                                       "launches", "stop_iteration")}
storm = SDSolver(cs.load_problem("stormlike"), SDConfig(EVAL_FLAG=False),
                 device=dev)
batch = make_eval_batch(storm.pa, storm.spec, 512)
gen = torch.Generator(device=dev).manual_seed(11)
w = sample_omega(storm.spec, gen, 512, dtype=storm.pa.c1.dtype)
x = torch.as_tensor(storm.mean_sol, device=dev)
batch(x, w_raw=w)                        # the cold mean observation first
torch.cuda.synchronize()
pivots = batch.pivots
t = time.monotonic()
batch(x, w_raw=w)
torch.cuda.synchronize()
out["eval512_seconds"] = time.monotonic() - t
out["eval512_pivots"] = batch.pivots - pivots
print(json.dumps(out), flush=True)
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the first checkout")
    ap.add_argument("--b", default=".", help="the second (default: this)")
    ap.add_argument("--pairs", type=int, default=1,
                    help="a, b, b, a this many times")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in (args.a, args.b)]
    for _ in range(args.pairs):
        for root in (roots[0], roots[1], roots[1], roots[0]):
            subprocess.run([sys.executable, "-c", CHILD, root], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
