"""Time the port's triple masked argmax kernel on the card, as chip_smoke.py
phase 2 times it, for one checkout of the package or two side by side.

    python3 scripts/torch_argmax_bench.py                  # this checkout
    python3 scripts/torch_argmax_bench.py --root OTHER     # another one
    python3 scripts/torch_argmax_bench.py --sweep          # other splits

At the main path's shape (7501, 5120) it times the full table (random masks
with p = 0.9 / 0.5 / 0.3) and the pool prefixes of 0, 64 and 512 rows: the
median over 30 launches, each between its own CUDA events after a 512 MB
write that flushes L2 and a spin that keeps the card ahead of the host
(chip_smoke.py's ``cuda_ms``), beside the bytes bound
of the rows the masks select (``bound_ms``) and the kernel's own device
time under torch.profiler (``profiler_ms``).  ``--root`` imports
``stochasticdecomposition_torch`` from another checkout (an unpacked
``git archive`` of a parent commit, say), so two versions are compared in
one run on one card.  ``--sweep`` also times other numbers of S-splits,
each checked against the plain version first.  Prints
the card's name and power limit, then one JSON line per (root, plan, case).
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smoke = load_smoke()
    print(smoke.nvidia_smi_line(), flush=True)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from stochasticdecomposition_torch.ops import argmax

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    S, O = 7501, 5120
    H = torch.as_tensor(rng.standard_normal((S, O)), device=dev)
    flush = torch.empty(smoke.FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    s = np.arange(S)
    cases = {"full": [rng.random(S) < p for p in (0.9, 0.5, 0.3)]}
    for n in (0, *smoke.PREFIXES):
        old = s < n - n // 4
        cases[f"prefix{n}"] = [s < n, old, (s < n) & ~old]

    plans = [None]
    if args.sweep and hasattr(argmax, "split_plan"):
        plans += [argmax.split_plan(S, O, n_splits=n)
                  for n in (2, 3, 4, 5, 8, 12, 24)]
    for plan in plans:
        kw = {} if plan is None else {"plan": plan}
        for name, np_masks in cases.items():
            masks = [torch.as_tensor(m, device=dev) for m in np_masks]
            got = argmax.triple_masked_argmax(H, *masks, **kw)
            want = argmax.triple_masked_argmax_plain(H, *masks)
            torch.cuda.synchronize()
            if not all(smoke.same(g, w) for g, w in zip(got, want)):
                sys.exit(f"kernel differs from the plain version: {plan} "
                         f"{name}")
            b_ms, nbytes, n_sel = smoke.bound_ms(np_masks, O)
            def fn():
                return argmax.triple_masked_argmax(H, *masks, **kw)

            ms = smoke.cuda_ms(fn, smoke.TIMED_REPS, flush)
            print(json.dumps({
                "root": args.root, "case": name, "shape": [S, O],
                "plan": None if plan is None else plan._asdict(),
                "n_sel": n_sel, "ms": ms,
                "profiler_ms": smoke.profiler_ms(fn, 10, flush),
                "bound_ms": b_ms,
                "bound_share": b_ms / ms,
                "GBps": nbytes / (ms * 1e-3) / 1e9}), flush=True)


if __name__ == "__main__":
    main()
