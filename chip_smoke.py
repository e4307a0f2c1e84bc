"""Drive the PyTorch port of SD on one CUDA card, phase by phase.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds; any failure exits non-zero
(nothing is swallowed).  Phases:

  0. device   — requires CUDA; the card's name and power limit (nvidia-smi),
                torch and CUDA versions.
  1. build    — builds the kernel library from csrc/ with nvcc if missing.
  2. kernel   — the triple masked argmax kernel against its plain PyTorch
                version on f64 data from a numpy seed, at the main path's
                shapes up to the default (7501, 5120), plus empty masks,
                all-equal H and NaN cases: all six outputs must be equal.
                Kernel, plain version and memory bound timed at (7501, 5120).
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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def argmax_cases(rng, S, O, dev):
    """Random f64 heights with random masks, plus the edge cases."""
    H = torch.as_tensor(rng.standard_normal((S, O)) * 100.0, device=dev)
    masks = [torch.as_tensor(rng.random(S) < p, device=dev)
             for p in (0.9, 0.5, 0.3)]
    yield "random", H, masks
    none = torch.zeros(S, dtype=torch.bool, device=dev)
    yield "empty", H, [none, masks[1], none]
    yield "ties", torch.full((S, O), 3.25, dtype=torch.float64, device=dev), \
        [torch.ones(S, dtype=torch.bool, device=dev), masks[1], masks[2]]
    Hn = H.clone()
    Hn[S // 2, :] = float("nan")
    Hn[S // 3, ::2] = float("nan")
    yield "nan", Hn, masks


def phase_kernel(dev):
    from stochasticdecomposition_torch.ops import argmax

    rng = np.random.default_rng(20261017)
    checked = 0
    max_err = 0.0
    for S, O in ARGMAX_SHAPES:
        for case, H, masks in argmax_cases(rng, S, O, dev):
            got = argmax.triple_masked_argmax(H, *masks)
            want = argmax.triple_masked_argmax_plain(H, *masks)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                # Exact equality, NaN matching NaN.
                same = g.dtype == w.dtype and g.shape == w.shape and bool(
                    torch.all((g == w) | (torch.isnan(g) & torch.isnan(w))))
                if not same:
                    fail(f"argmax kernel differs from its plain version at "
                         f"{(S, O)} case {case}")
                both = torch.isfinite(g) & torch.isfinite(w)
                if g.is_floating_point() and bool(torch.any(both)):
                    max_err = max(max_err,
                                  float(torch.amax(torch.abs(g - w)[both])))
            checked += 1
    S, O = ARGMAX_SHAPES[-1]
    H = torch.as_tensor(rng.standard_normal((S, O)), device=dev)
    masks = [torch.as_tensor(rng.random(S) < p, device=dev)
             for p in (0.9, 0.5, 0.3)]
    ms = cuda_ms(lambda: argmax.triple_masked_argmax(H, *masks), 20)
    plain_ms = cuda_ms(lambda: argmax.triple_masked_argmax_plain(H, *masks), 5)
    nbytes = S * O * 8 + 3 * S + 3 * O * (8 + 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"cases": checked, "shape": [S, O], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "GBps": nbytes / (ms * 1e-3) / 1e9, "bytes": nbytes}


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
    emit({"phase": "build", "nvcc_seconds": build_s,
          "library": str(kernels.LIB_PATH.relative_to(
              kernels.LIB_PATH.parents[2])),
          "seconds": time.monotonic() - t})

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
    emit({"kernels": [{
        "name": "triple_masked_argmax", "route": "cuda",
        "source": "stochasticdecomposition_torch/csrc/triple_argmax.cu",
        "replaces": "stochasticdecomposition_tpu/ops/pallas_argmax.py:191",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
