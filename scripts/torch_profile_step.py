"""Where an SD iteration of the PyTorch port spends its time on the card.

Runs the port's SD (``--batch`` observations per step, 1 by default) at the
default pool capacities on one instance for a warm-up, then ``--iters``
more steps under ``torch.profiler`` (CPU and CUDA activities), and prints
JSON lines: the wall seconds per step, the device busy time per step (sum
of CUDA kernel time), the device's idle share, the triple masked argmax
kernel's launches and device time per launch (with the sigma pool's size at
the end), and the top kernels by device time and the top operators by host
time.  With ``--eval-lanes N`` the profiled window is ``--iters``
out-of-sample evaluation batches of N lanes at the incumbent after the
warm-up instead (the mean observation's solve is made before the window).

    python3 scripts/torch_profile_step.py --instance lands --iters 40
    python3 scripts/torch_profile_step.py --instance stormlike --iters 6
    python3 scripts/torch_profile_step.py --instance pgp2like --batch 64
    python3 scripts/torch_profile_step.py --instance stormlike --warmup 2 \
        --iters 2 --eval-lanes 512

Needs a CUDA card; prints the card's name and power limit first.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from stochasticdecomposition_torch.config import SDConfig  # noqa: E402
from stochasticdecomposition_torch.core.state import init_state  # noqa: E402
from stochasticdecomposition_torch.models.instances import (  # noqa: E402
    INSTANCES, load_instance,
)
from stochasticdecomposition_torch.models.suite import (  # noqa: E402
    load_suite_instance,
)
from stochasticdecomposition_torch.prob import (  # noqa: E402
    attach_stoc, decompose,
)
from stochasticdecomposition_torch.runner import (  # noqa: E402
    SDSolver, replication_generators,
)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--instance", default="lands")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--eval-lanes", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)

    load = load_instance if args.instance in INSTANCES else \
        load_suite_instance
    core, tim, stoc = load(args.instance)
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    # Default pool capacities (MAX_ITER=5000), stop test off: the loop
    # below drives the step directly.
    cfg = SDConfig(EVAL_FLAG=False, SAMPLE_INCREMENT=args.batch)
    solver = SDSolver(sp, cfg)
    gen, _ = replication_generators(cfg.RUN_SEED[0], solver.device)
    state = init_state(solver.pa, solver.caps, cfg, solver.mean_sol)
    for _ in range(args.warmup):
        state = solver.step(state, gen)
    torch.cuda.synchronize()

    if args.eval_lanes:
        from stochasticdecomposition_torch.core.evaluate import (
            eval_generator, make_eval_batch,
        )
        fn = make_eval_batch(solver.pa, solver.spec, args.eval_lanes)
        egen = eval_generator(cfg.EVAL_SEED[0], solver.device)
        fn(state.incumb_x, egen)              # the mean observation's solve
        torch.cuda.synchronize()
        pivots0 = fn.pivots
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(args.iters):
                fn(state.incumb_x, egen)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(prof, wall, args, {
            "eval_lanes": args.eval_lanes,
            "pivots_per_batch": (fn.pivots - pivots0) / args.iters},
            state)
        return

    pivots0, lps0, qp0 = state.lp_pivots, state.lp_cnt, state.qp_iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(args.iters):
            state = solver.step(state, gen)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    n = args.iters
    report(prof, wall, args, {
        "batch": args.batch, "k_end": state.k,
        "lps_per_iter": (state.lp_cnt - lps0) / n,
        "pivots_per_iter": (state.lp_pivots - pivots0) / n,
        "ipm_iters_per_iter": (state.qp_iters - qp0) / n}, state)


def report(prof, wall, args, fields, state):
    """The JSON lines of one profiled window of ``args.iters`` calls."""
    events = prof.key_averages()
    # Device time of the kernels themselves (the aten operators that
    # launch them report the same time again).
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    n = args.iters
    print(json.dumps({
        "instance": args.instance, "iters": n, **fields,
        "wall_s_per_iter": wall / n,
        "device_busy_ms_per_iter": busy_us / 1e3 / n,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "note": "wall includes profiler overhead"}), flush=True)
    argmax = [e for e in kernels if "triple_argmax" in e.key]
    calls = sum(e.count for e in argmax)
    print(json.dumps({"argmax_kernel": {
        "calls": calls, "calls_per_iter": calls / n,
        "device_ms_per_launch": sum(_device_us(e) for e in argmax) / 1e3 /
        max(calls, 1),
        "sigma_cnt_end": int(state.sigma_cnt)}}), flush=True)
    by_dev = sorted(kernels, key=_device_us, reverse=True)[:args.top]
    print(json.dumps({"top_device": [
        {"name": e.key[:60], "calls": e.count,
         "device_ms_per_iter": _device_us(e) / 1e3 / n} for e in by_dev]}))
    ops = [e for e in events if e.key.startswith("aten::")]
    by_host = sorted(ops, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:args.top]
    print(json.dumps({"top_host": [
        {"name": e.key, "calls_per_iter": e.count / n,
         "host_ms_per_iter": e.self_cpu_time_total / 1e3 / n}
        for e in by_host]}))


if __name__ == "__main__":
    main()
