"""Run one suite instance to the STATISTICAL stop on the card.

The port's counterpart of the JAX package's ``scripts/suite_to_stop.py``:
samples to the stop, steady samples/s, pool sizes and pool memory at real
iteration counts for the large suite members (stormlike 528x1259/118RV,
ssnlike 175x706/86RV; reference scales from sd_experiments.sh:21).  Prints
ONE JSON line with the JAX script's keys; stdout is machine-readable,
progress goes to stderr.  Runs on the CUDA card unless ``--device cpu``
asks for the CPU.

Usage:
    python -m stochasticdecomposition_torch.suite_to_stop stormlike \
        --tol l --si 64 --max-iter 4096 [--device cpu]

``run(...)`` is the same body for callers in the same process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# The steady rate's calls of the step, as the JAX package's script asks
# ``bench.py::bench_sd_rate`` for them (n_iter=6, warmup=3).
STEADY_CALLS = 6
STEADY_WARMUP = 3


def steady_rate(solver):
    """Samples/s of the SD step on a fresh state (the JAX package's
    ``bench.py::bench_sd_rate``): STEADY_WARMUP calls of the step untimed
    (cold pools and a far warm-start basis), then STEADY_CALLS - 1 timed
    calls, the card synchronised before each clock read.  A call of the
    step is CHECK_EVERY steps of SAMPLE_INCREMENT samples.  Returns
    (samples/s, the final state)."""
    import torch

    from stochasticdecomposition_torch.core.state import init_state
    from stochasticdecomposition_torch.runner import replication_generators

    cfg = solver.cfg
    dev = solver.device
    gen, _ = replication_generators(3, dev)
    state = init_state(solver.pa, solver.caps, cfg, solver.mean_sol)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(STEADY_WARMUP):
        state = solver.step(state, gen)
    sync()
    t0 = time.perf_counter()
    for _ in range(STEADY_CALLS - 1):
        state = solver.step(state, gen)
    sync()
    dt = time.perf_counter() - t0
    samples = (STEADY_CALLS - 1) * max(1, cfg.SAMPLE_INCREMENT) * \
        max(1, cfg.CHECK_EVERY)
    return samples / dt, state


def suite_config(tol: str, si: int, max_iter: int, check_every: int,
                 f32_pivot: bool = False,
                 max_lambda: int | None = None,
                 max_omega: int | None = None):
    """The run's SDConfig, built as the JAX script builds it.
    SUBPROB_F32_PIVOT is recorded and changes nothing: the port solves in
    f64."""
    from stochasticdecomposition_torch.config import SDConfig

    cfg = SDConfig(MAX_ITER=max_iter, EVAL_FLAG=False, SAMPLE_INCREMENT=si,
                   CHECK_EVERY=check_every, SUBPROB_F32_PIVOT=f32_pivot,
                   MAX_LAMBDA=max_lambda, MAX_SIGMA=max_lambda,
                   MAX_OMEGA=max_omega)
    return cfg.apply_tolerance_preset(tol)


def run(name: str, tol: str = "l", si: int = 8, max_iter: int = 4096,
        check_every: int = 4, seed_rep: int = 0, f32_pivot: bool = False,
        max_lambda: int | None = None, max_omega: int | None = None,
        device=None, metrics=None, details: dict | None = None) -> dict:
    """One replication (RUN_SEED[seed_rep]) of suite instance ``name`` to
    the statistical stop or ``max_iter`` samples, then the steady rate;
    returns the JSON line's fields; progress goes to stderr.  ``device=None``
    is the CUDA card.  ``metrics``, if given, has its ``record(state)``
    called after every call of the step of the replication
    (``SDSolver.solve_replication``'s).  ``details``, if given, receives what a caller checks beyond the line: ``solver``,
    ``result`` (the ReplicationResult) and ``steady_state`` (the final state
    of the steady-rate run)."""
    import torch

    from stochasticdecomposition_torch.models.suite import load_suite_instance
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.runner import SDSolver

    def log(s):
        print(s, file=sys.stderr, end="", flush=True)

    t0 = time.perf_counter()
    core, tim, stoc = load_suite_instance(name)
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    cfg = suite_config(tol, si, max_iter, check_every, f32_pivot,
                       max_lambda, max_omega)
    solver = SDSolver(sp, cfg, device=device)
    t_setup = time.perf_counter() - t0
    log(f"[{name}] setup {t_setup:.1f}s; caps={solver.caps}, "
        f"pool_mem={solver.pool_bytes['total'] / 2**20:.0f}MiB\n")

    t0 = time.perf_counter()
    r = solver.solve_replication(seed_rep, log=log, metrics=metrics)
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    wall = time.perf_counter() - t0
    log("\n")

    steady, steady_state = steady_rate(solver)
    dev = solver.device
    out = {
        "instance": name,
        "tolerance": tol,
        "sample_increment": si,
        "check_every": check_every,
        "f32_pivot": bool(f32_pivot),
        "samples_to_stop": r.iterations,
        "stopped_statistically": bool(r.optimal),
        "wall_s": round(wall, 1),
        "setup_s": round(t_setup, 1),
        "samples_per_s": round(r.iterations / wall, 2),
        "samples_per_s_steady": round(steady, 2),
        "lb_estimate": round(r.incumb_est, 4),
        "pools": r.pool_sizes,
        "cuts_active": r.cuts_active,
        "quad_scalar": round(r.quad_scalar, 6),
        "pool_mem_mb": round(solver.pool_bytes["total"] / 2**20, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
    }
    if details is not None:
        details.update(solver=solver, result=r, steady_state=steady_state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("name")
    ap.add_argument("--tol", default="l", choices=["l", "n", "t"])
    ap.add_argument("--si", type=int, default=8,
                    help="SAMPLE_INCREMENT (new observations per step)")
    ap.add_argument("--max-iter", type=int, default=4096,
                    help="sample budget (k counts samples)")
    ap.add_argument("--check-every", type=int, default=4)
    ap.add_argument("--seed-rep", type=int, default=0)
    ap.add_argument("--f32-pivot", action="store_true",
                    help="SUBPROB_F32_PIVOT: recorded in the line; the port "
                         "pivots in f64 either way")
    ap.add_argument("--max-lambda", type=int, default=None,
                    help="pin lambda AND sigma pool capacity (the default "
                         "derives them from MAX_ITER, setup.c:136-139)")
    ap.add_argument("--max-omega", type=int, default=None,
                    help="pin omega pool capacity")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.name, tol=args.tol, si=args.si, max_iter=args.max_iter,
              check_every=args.check_every, seed_rep=args.seed_rep,
              f32_pivot=args.f32_pivot, max_lambda=args.max_lambda,
              max_omega=args.max_omega, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
