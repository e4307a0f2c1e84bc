"""Experiment sweep driver: problem x tolerance x sample-increment.

The port's counterpart of the JAX package's root ``sweep.py``, which
replaces the reference's sd_experiments.sh (a loop over problem x
sample-increment x tolerance invoking the binary, sd_experiments.sh:27-34;
SAMPLE_INCREMENT is a real mode here).  Emits one TSV row and one JSONL
record per combination, with the same columns and keys as the JAX driver;
``--parity MAX_SCEN`` adds the exact gap of the incumbent against the
extensive-form optimum where the joint support is enumerable.  A row that
raises is written as ``ERROR: ...`` and the sweep goes on.  Runs on the
CUDA card unless ``--device cpu`` asks for the CPU.

Usage:
  python -m stochasticdecomposition_torch.sweep            # default suite
  python -m stochasticdecomposition_torch.sweep -p lands,pgp2like -t l,n \
      -s 1,16 -o /tmp/sweep [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HEADER = ("problem\ttolerance\tbatch\titerations\toptimal\twall_s\t"
          "lb_estimate\teval_ub\teval_ci_lo\teval_ci_hi\teval_obs\t"
          "pools(o/l/s/cuts)\tef_opt\texact_gap\n")

# (ef_opt, exact_fn) by (problem, device): the enumerated scenarios and the
# extensive form are built once per problem and reused across its
# tolerance/batch rows.
_parity_cache = {}


def _load(name):
    from stochasticdecomposition_torch.models.instances import (
        INSTANCES, load_instance,
    )
    from stochasticdecomposition_torch.models.suite import (
        SUITE, load_suite_instance,
    )

    if name in INSTANCES:
        return load_instance(name)
    if name in SUITE:
        return load_suite_instance(name)
    raise ValueError(f"unknown problem {name!r}")


def _parity_oracle(name, solver, stoc, max_scenarios):
    """(ef_opt, exact_fn) when the joint support is enumerable, else None."""
    key = (name, solver.device)
    if key in _parity_cache:
        return _parity_cache[key]
    from stochasticdecomposition_torch.models.extensive import (
        enumerate_scenarios, exact_objective_fn, scenario_count,
        solve_extensive_form,
    )

    n = scenario_count(stoc)
    out = None
    if 0 < n <= max_scenarios:
        outs, probs = enumerate_scenarios(stoc, solver.sp.rv_order)
        ef_obj, _ = solve_extensive_form(solver.sp, outs, probs)
        out = (ef_obj, exact_objective_fn(solver.pa, outs, probs))
    _parity_cache[key] = out
    return out


def run_one(name, tol, batch, max_iter, eval_flag, max_scenarios=0,
            device=None):
    """One replication (RUN_SEED[0]) of ``name`` at preset ``tol`` and
    SAMPLE_INCREMENT ``batch`` in a fresh solver; returns (result,
    evaluation or None, wall seconds, ef_opt, exact gap)."""
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.runner import SDSolver

    core, tim, stoc = _load(name)
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    cfg = SDConfig(MAX_ITER=max_iter, EVAL_FLAG=eval_flag,
                   SAMPLE_INCREMENT=batch).apply_tolerance_preset(tol)
    solver = SDSolver(sp, cfg, device=device)
    t0 = time.perf_counter()
    r = solver.solve_replication(0)
    wall = time.perf_counter() - t0
    ev = solver.evaluate_x(r.incumb_x) if eval_flag else None
    ef_opt = gap = None
    if max_scenarios:
        oracle = _parity_oracle(name, solver, stoc, max_scenarios)
        if oracle is not None:
            ef_opt, exact = oracle
            gap = abs(exact(r.incumb_x) - ef_opt) / max(abs(ef_opt), 1e-12)
    return r, ev, wall, ef_opt, gap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-p", "--problems",
                    default="lands,pgp2like,cep1like,baa99like")
    ap.add_argument("-t", "--tolerances", default="l,n",
                    help="comma list of presets: l/n/t")
    ap.add_argument("-s", "--sample-increments", default="1,16",
                    help="comma list of SAMPLE_INCREMENT values")
    ap.add_argument("--max-iter", type=int, default=1500)
    ap.add_argument("-e", "--eval", type=int, default=1)
    ap.add_argument("-o", "--output", default="./sweep_out")
    ap.add_argument("--parity", type=int, default=0, metavar="MAX_SCEN",
                    help="when > 0, report the EXACT objective gap vs the "
                         "extensive-form optimum for problems whose joint "
                         "support has at most MAX_SCEN scenarios")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from stochasticdecomposition_torch.device import resolve_device

    # Outside the per-row handler: no card is an error of the whole sweep.
    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    tsv_path = os.path.join(args.output, "sweep_results.tsv")
    jsonl_path = os.path.join(args.output, "sweep_results.jsonl")
    problems = args.problems.split(",")
    tols = args.tolerances.split(",")
    batches = [int(b) for b in args.sample_increments.split(",")]

    with open(tsv_path, "w") as tsv, open(jsonl_path, "w") as jl:
        tsv.write(HEADER)
        sys.stdout.write(HEADER)
        for name in problems:
            for tol in tols:
                for batch in batches:
                    # The JAX driver's semantics: a failed row is recorded
                    # and the sweep goes on to the next.
                    try:
                        r, ev, wall, ef_opt, gap = run_one(
                            name, tol, batch, args.max_iter, bool(args.eval),
                            max_scenarios=args.parity, device=device)
                    except Exception as e:
                        row = f"{name}\t{tol}\t{batch}\tERROR: {e}\n"
                        tsv.write(row)
                        sys.stdout.write(row)
                        continue
                    pools = (f"{r.pool_sizes['omega']}/{r.pool_sizes['lam']}/"
                             f"{r.pool_sizes['sigma']}/{r.pool_sizes['cuts']}")
                    if ev is not None:
                        evs = (f"{ev.mean:.4f}\t{ev.ci_low:.4f}\t"
                               f"{ev.ci_high:.4f}\t{ev.count}")
                    else:
                        evs = "-\t-\t-\t-"
                    efs = f"{ef_opt:.4f}" if ef_opt is not None else "-"
                    gps = f"{gap:.6f}" if gap is not None else "-"
                    row = (f"{name}\t{tol}\t{batch}\t{r.iterations}\t"
                           f"{int(r.optimal)}\t{wall:.2f}\t"
                           f"{r.incumb_est:.4f}\t{evs}\t{pools}\t"
                           f"{efs}\t{gps}\n")
                    tsv.write(row)
                    tsv.flush()
                    sys.stdout.write(row)
                    sys.stdout.flush()
                    jl.write(json.dumps({
                        "problem": name, "tolerance": tol, "batch": batch,
                        "iterations": r.iterations, "optimal": r.optimal,
                        "wall_s": round(wall, 2),
                        "lb_estimate": r.incumb_est,
                        "eval": ev._asdict() if ev else None,
                        "pools": r.pool_sizes,
                        "ef_opt": ef_opt, "exact_gap": gap,
                    }) + "\n")
                    jl.flush()
    print(f"\nsweep written to {tsv_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
