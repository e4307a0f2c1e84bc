"""The compromise QP of two short stormlike replications, in both packages.

Two replications of ``stormlike`` (RUN_SEED[0] and RUN_SEED[1]) at
SAMPLE_INCREMENT 8 for 6 steps at the default pool capacities — the
``stormlike_b8`` phase of ``chip_smoke.py`` — give two ``BatchEntry``; their
compromise QP (244 variables, 121 ties, proximal weight ~0.0013) is solved by
the port's ``solve_compromise`` (IPM cap 100, as the JAX package's) and,
with ``--jax``, by the JAX package's at caps 100 and 200.  The JAX package's
interior-point loop stalls on this QP and ends uncertified on its last
iterate; the port's, whose dual step takes the clamped barrier weights
(``ops/qp.py``, ``consistent_clamp``), certifies it before the cap.
Prints one JSON line per solve (package, device, cap, iterations,
certified, objective, seconds), and on the card the card as nvidia-smi
gives it.

On the card (the replications, then the solve; about 2 minutes):

    python3 scripts/torch_compromise_storm.py --save out/storm_entries.npz

On the CPU, from saved entries, both packages (about 2 minutes):

    JAX_PLATFORMS=cpu python scripts/torch_compromise_storm.py \\
        --device cpu --entries out/storm_entries.npz --jax
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stochasticdecomposition_torch.config import SDConfig  # noqa: E402
from stochasticdecomposition_torch.core import compromise  # noqa: E402
from stochasticdecomposition_torch.models.suite import (  # noqa: E402
    load_suite_instance,
)
from stochasticdecomposition_torch.prob import (  # noqa: E402
    attach_stoc, decompose,
)
from stochasticdecomposition_torch.runner import SDSolver  # noqa: E402

JAX_CAPS = (100, 200)
BATCH, STEPS = 8, 6


def entries_from_file(path):
    data = np.load(path)
    return [compromise.BatchEntry(**{
        f.name: data[f"r{i}_{f.name}"] if data[f"r{i}_{f.name}"].ndim
        else data[f"r{i}_{f.name}"].item()
        for f in dataclasses.fields(compromise.BatchEntry)}) for i in (0, 1)]


def recorded(solve_qp, line, cap=None):
    """``solve_qp`` (at ``cap`` if given) printing one JSON line a solve."""
    def solve(*a, **kw):
        if cap is not None:
            kw = {**kw, "max_iter": cap}
        t = time.monotonic()
        res = solve_qp(*a, **kw)
        certified = bool(res.converged)
        print(json.dumps({**line, "cap": kw["max_iter"],
                          "iters": int(res.iters), "certified": certified,
                          "objective": float(res.obj),
                          "seconds": time.monotonic() - t}), flush=True)
        return res
    return solve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", help="saved entries instead of running")
    ap.add_argument("--save", help="where to save the entries")
    ap.add_argument("--jax", action="store_true",
                    help="also solve with the JAX package (CPU)")
    args = ap.parse_args()

    core, tim, stoc = load_suite_instance("stormlike")
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    cfg = SDConfig(EVAL_FLAG=False, SAMPLE_INCREMENT=BATCH,
                   MAX_ITER=STEPS * BATCH, MAX_OMEGA=5001, MAX_LAMBDA=7501,
                   MAX_SIGMA=7501)
    solver = SDSolver(sp, cfg, device=args.device)
    if args.entries:
        entries = entries_from_file(args.entries)
    else:
        entries = []
        for rep in (0, 1):
            t = time.monotonic()
            r = solver.solve_replication(rep)
            print(json.dumps({"replication": rep, "samples": r.iterations,
                              "seconds": time.monotonic() - t}), flush=True)
            entries.append(r.batch_entry)
        if args.save:
            Path(args.save).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(args.save, **{
                f"r{i}_{k}": np.asarray(v) for i, e in enumerate(entries)
                for k, v in dataclasses.asdict(e).items()})

    solve_qp = compromise.solve_qp
    compromise.solve_qp = recorded(solve_qp, {"package": "port",
                                              "device": args.device})
    if args.device == "cuda":
        torch.cuda.synchronize()
    x, obj, ok = compromise.solve_compromise(solver.pa, entries,
                                             _return_obj=True)
    compromise.solve_qp = solve_qp
    print(json.dumps({"compromise_x_first": x[:4].tolist(),
                      "n1": int(x.shape[0])}), flush=True)

    if args.jax:
        import jax

        from stochasticdecomposition_tpu.core import compromise as jc
        from stochasticdecomposition_tpu.core.state import (
            stage_problem as jax_stage,
        )
        from stochasticdecomposition_tpu.models.suite import (
            load_suite_instance as jax_load,
        )
        from stochasticdecomposition_tpu.prob import decompose as jax_dec

        jax.config.update("jax_enable_x64", True)
        jpa = jax_stage(jax_dec(*jax_load("stormlike")))
        jentries = [jc.BatchEntry(**dataclasses.asdict(e)) for e in entries]
        jax_solve_qp = jc.solve_qp
        for cap in JAX_CAPS:
            jc.solve_qp = recorded(jax_solve_qp, {"package": "jax",
                                                  "device": "cpu"}, cap)
            jc.solve_compromise(jpa, None, jentries, _return_obj=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
