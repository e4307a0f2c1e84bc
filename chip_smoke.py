"""Drive the PyTorch port of SD on one CUDA card, phase by phase.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds; any failure exits non-zero
(nothing is swallowed).  Phases:

  0. device   — requires CUDA; the card's name and power limit (nvidia-smi),
                torch and CUDA versions.
  1. build    — builds the kernel library from csrc/ with nvcc if missing.
  2. kernel   — the triple masked argmax kernel against its plain PyTorch
                version on f64 data from a numpy seed, at the main path's
                shapes up to the default (7501, 5120): random masks, empty
                masks, all-equal H and NaN, and the edge cases of
                ops/argmax_cases.py (pool prefixes of 64 and 512 rows, a
                selected -inf, selected -1e300, NaN in unselected rows, NaN
                and ties across split boundaries, a row tile and a split no
                mask selects), under the default split and, at (3000, 1024),
                under 2 and 40 S-splits and with cp.async copies: all six outputs
                must be equal.  Timed at (7501, 5120) with random masks (the
                full table) and with the pool prefixes: the median of 30
                launches, each between its own CUDA events after a 512 MB
                write that flushes L2 and a spin that keeps the card ahead
                of the host, beside the bytes bound of the rows the masks
                select; one case cross-checked with
                torch.profiler's device time of the kernel.
  3. lands    — batch-1 SD at the default SDConfig (MAX_ITER=5000 pool
                capacities, no evaluation) to the certified stop; exact gap
                of the incumbent against the extensive-form optimum.
  4. pgp2like — the same.
  5. stormlike — default capacities, a fixed 24 iterations: every LP
                optimal, every cut and master solve certified.

Then a line with the card as nvidia-smi gives it, a ``kernels`` JSON line,
and last ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Extensive-form optima of the finite-support instances (RESULTS.md §1).
OPTIMA = {"lands": 382.0222, "pgp2like": 113.3000}
GAP_LIMIT = 0.01
STORM_ITERS = 24
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
ARGMAX_SHAPES = [(37, 128), (300, 256), (3000, 1024), (1001, 777),
                 (7501, 5120)]
PREFIXES = (64, 512)             # pool-prefix cases, rows selected
TIMED_REPS = 30
FLUSH_BYTES = 512 * 2 ** 20      # > the 50 MB L2; keeps the card ahead


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(json.dumps({"error": msg}), file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, flush) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches, each between its
    own pair of CUDA events, after a write of ``flush`` (which empties L2 of
    the inputs, as the main path's height_table does) and a ~0.5 ms spin
    that keeps the card busy while the host enqueues ``fn``, after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        flush.fill_(i)
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def profiler_ms(fn, reps: int, flush) -> float:
    """The kernel's own device time per launch under torch.profiler (a
    profiling session now and then records no kernel: up to three)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "argmax_kernel" in e.key:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                return float(us) / 1e3 / e.count
    fail("torch.profiler saw no argmax kernel in three sessions")


def same(g, w) -> bool:
    """Exact equality, NaN matching NaN."""
    return g.dtype == w.dtype and g.shape == w.shape and bool(
        torch.all((g == w) | (torch.isnan(g) & torch.isnan(w))))


def bound_ms(masks, O) -> tuple:
    """The bytes the function must move — the rows some mask selects, read
    once, the three masks and the six [O] outputs — over the HBM rate;
    n_sel is counted on the host from the masks."""
    n_sel = int(np.count_nonzero(masks[0] | masks[1] | masks[2]))
    S = masks[0].shape[0]
    nbytes = n_sel * O * 8 + 3 * S + 48 * O
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, n_sel


def phase_kernel(dev):
    from stochasticdecomposition_torch.ops import argmax, argmax_cases

    rng = np.random.default_rng(20261017)
    checked = 0
    max_err = 0.0
    for S, O in ARGMAX_SHAPES:
        plans = [None]
        if (S, O) == (3000, 1024):
            plans += [argmax.split_plan(S, O, n_splits=2),
                      argmax.split_plan(S, O, n_splits=40),
                      argmax.split_plan(S, O, aligned=False)]
        for plan in plans:
            splits = (plan or argmax.split_plan(S, O)).n_splits
            for case, H, masks in argmax_cases.cases(rng, S, O, splits,
                                                     PREFIXES):
                H = torch.as_tensor(H, device=dev)
                masks = [torch.as_tensor(m, device=dev) for m in masks]
                got = argmax.triple_masked_argmax(H, *masks, plan=plan)
                want = argmax.triple_masked_argmax_plain(H, *masks)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if not same(g, w):
                        fail(f"argmax kernel differs from its plain version "
                             f"at {(S, O)} case {case} plan {plan}")
                    both = torch.isfinite(g) & torch.isfinite(w)
                    if g.is_floating_point() and bool(torch.any(both)):
                        max_err = max(max_err, float(
                            torch.amax(torch.abs(g - w)[both])))
                checked += 1

    S, O = ARGMAX_SHAPES[-1]
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    H = torch.as_tensor(rng.standard_normal((S, O)), device=dev)
    timed = {"full": argmax_cases.random_masks(rng, S)}
    for n in PREFIXES:
        timed[f"prefix{n}"] = list(argmax_cases.prefix_masks(S, n))
    out = {"cases": checked, "shape": [S, O], "max_abs_err": max_err,
           "plan": argmax.split_plan(S, O)._asdict(), "timed": {}}
    for name, np_masks in timed.items():
        b_ms, nbytes, n_sel = bound_ms(np_masks, O)
        masks = [torch.as_tensor(m, device=dev) for m in np_masks]
        ms = cuda_ms(lambda: argmax.triple_masked_argmax(H, *masks),
                     TIMED_REPS, flush)
        row = {"n_sel": n_sel, "ms": ms, "bound_ms": b_ms, "bytes": nbytes,
               "GBps": nbytes / (ms * 1e-3) / 1e9,
               "bound_share": b_ms / ms}
        if name == "full":
            row["plain_ms"] = cuda_ms(
                lambda: argmax.triple_masked_argmax_plain(H, *masks),
                TIMED_REPS, flush)
            row["profiler_ms"] = profiler_ms(
                lambda: argmax.triple_masked_argmax(H, *masks), 10, flush)
        out["timed"][name] = row
    return out


def run_sd(name, dev, cfg):
    """One replication through SDSolver, the user's entry point; returns
    (solver, result, kernel launches during the run)."""
    from stochasticdecomposition_torch.models.instances import load_instance
    from stochasticdecomposition_torch.models.suite import load_suite_instance
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.runner import SDSolver

    load = load_instance if name in OPTIMA else load_suite_instance
    core, tim, stoc = load(name)
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    solver = SDSolver(sp, cfg, device=dev)
    argmax.launches = 0
    res = solver.solve_replication(0)
    torch.cuda.synchronize()
    return solver, res, argmax.launches


def phase_to_stop(name, dev):
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.models.extensive import (
        enumerate_scenarios, exact_objective_fn,
    )

    solver, res, launches = run_sd(name, dev, SDConfig(EVAL_FLAG=False))
    outs, probs = enumerate_scenarios(solver.sp._stoc, solver.sp.rv_order)
    exact = exact_objective_fn(solver.pa, outs, probs)(res.incumb_x)
    gap = abs(exact - OPTIMA[name]) / abs(OPTIMA[name])
    out = {"stop_iteration": res.iterations, "certified": res.optimal,
           "sd_seconds": res.time_total, "launches": launches,
           "cuts_formed": res.lp_count, "exact_objective": exact,
           "optimum": OPTIMA[name], "exact_gap": gap,
           "incumb_est": res.incumb_est, "pools": res.pool_sizes,
           "caps": solver.caps._asdict(), "full_tests": res.full_tests,
           "master_failures": res.master_failures,
           "pivots_per_lp": res.lp_pivots / max(res.lp_count, 1),
           "ipm_iters_per_master": res.qp_iters / max(res.iterations, 1)}
    if not res.optimal:
        fail(f"{name}: no certified stop before MAX_ITER ({out})")
    if gap > GAP_LIMIT:
        fail(f"{name}: exact gap {gap} exceeds {GAP_LIMIT} ({out})")
    if launches <= 0 or launches < res.lp_count:
        fail(f"{name}: {launches} kernel launches for {res.lp_count} cuts")
    return out


def phase_storm(dev):
    from stochasticdecomposition_torch.config import SDConfig

    # The default configuration's pool capacities (MAX_ITER=5000:
    # O=5120, L=S=7501), run for a fixed number of iterations.
    cfg = SDConfig(EVAL_FLAG=False, MAX_ITER=STORM_ITERS, MAX_OMEGA=5001,
                   MAX_LAMBDA=7501, MAX_SIGMA=7501)
    solver, res, launches = run_sd("stormlike", dev, cfg)
    out = {"iterations": res.iterations, "sd_seconds": res.time_total,
           "seconds_per_iteration": res.time_total / max(res.iterations, 1),
           "launches": launches, "lps": res.lp_count,
           "pivots_per_lp": res.lp_pivots / max(res.lp_count, 1),
           "ipm_iters_per_master": res.qp_iters / max(res.iterations, 1),
           "master_failures": res.master_failures,
           "incumb_est": res.incumb_est, "pools": res.pool_sizes,
           "caps": solver.caps._asdict()}
    # The runner raises on a non-optimal subproblem or a failed cut.
    if res.iterations != STORM_ITERS:
        fail(f"stormlike ran {res.iterations} of {STORM_ITERS} iterations")
    if res.master_failures:
        fail(f"stormlike: {res.master_failures} uncertified master solves")
    if launches <= 0:
        fail("stormlike: the argmax kernel was never launched")
    if not np.all(np.isfinite(res.incumb_x)):
        fail("stormlike: non-finite incumbent")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py runs on a CUDA card")
    # The package must be importable from this checkout.
    from stochasticdecomposition_torch.ops import kernels

    t_all = time.monotonic()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "seconds": time.monotonic() - t_all})

    t = time.monotonic()
    build_s = kernels.build()
    kernels.library()
    ptxas = [ln.strip() for ln in kernels.LOG_PATH.read_text().splitlines()
             if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_seconds": build_s,
          "library": str(kernels.LIB_PATH.relative_to(
              kernels.LIB_PATH.parents[2])),
          "ptxas": ptxas, "seconds": time.monotonic() - t})

    t = time.monotonic()
    kern = phase_kernel(dev)
    emit({"phase": "kernel", **kern, "seconds": time.monotonic() - t})

    launches = 0
    for name in ("lands", "pgp2like"):
        t = time.monotonic()
        out = phase_to_stop(name, dev)
        launches += out["launches"]
        emit({"phase": name, **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out = phase_storm(dev)
    launches += out["launches"]
    emit({"phase": "stormlike", **out, "seconds": time.monotonic() - t})

    emit({"phase": "total", "seconds": time.monotonic() - t_all})
    print(smi, flush=True)
    full = kern["timed"]["full"]
    emit({"kernels": [{
        "name": "triple_masked_argmax", "route": "cuda",
        "source": "stochasticdecomposition_torch/csrc/triple_argmax.cu",
        "replaces": "stochasticdecomposition_tpu/ops/pallas_argmax.py:191",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "prefix_ms": {str(n): kern["timed"][f"prefix{n}"]["ms"]
                      for n in PREFIXES},
        "prefix_bound_ms": {str(n): kern["timed"][f"prefix{n}"]["bound_ms"]
                            for n in PREFIXES}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
