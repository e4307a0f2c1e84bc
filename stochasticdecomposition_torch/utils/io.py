"""Result files and console summaries.

Reference: inout.c — detailedResults.csv (TSV schema at inout.c:20-24),
incumb.dat, summary.dat, and the console optimization/evaluation summaries
(inout.c:42-71).  The files are the JAX package's, field for field
(``utils/io.py`` there), so tooling that reads either reads both; only the
summary's "Algorithm" line names this implementation.
"""

from __future__ import annotations

import json
import os

from stochasticdecomposition_torch.core.evaluate import EvalResult
from stochasticdecomposition_torch.runner import ReplicationResult, RunResult

ALGORITHM = "Two-stage Stochastic Decomposition (PyTorch)"

_HEADER = ("Replication\tIterations\tLB estimate\tTotal time\tMaster time\t"
           " Subproblem time\t Optimality time\tArgmax time\t"
           "UB Estimate\tError\tCI-L\tCI-U\tOutcomes\n")


def write_detailed_results(path: str, result: RunResult) -> None:
    """detailedResults.csv (writeOptimizationStatistics, inout.c:16-39).

    The per-phase time columns (master/subproblem/optimality/argmax, the
    runTime struct of twoSD.h:87-99) are filled when the run asked for
    phase times (utils/metrics.estimate_phase_times); -1 = not measured."""
    with open(path, "w") as fh:
        fh.write(_HEADER)
        for r in result.replications:
            fh.write(f"{r.rep + 1}\t{r.iterations}\t{r.incumb_est:.4f}\t"
                     f"{r.time_total:.4f}\t{r.time_master:.4f}\t"
                     f"{r.time_subprob:.4f}\t{r.time_opttest:.4f}\t"
                     f"{r.time_argmax:.4f}")
            if r.eval is not None:
                e = r.eval
                fh.write(f"\t{e.mean:.4f}\t{e.error:.4f}\t{e.ci_low:.4f}\t"
                         f"{e.ci_high:.4f}\t{e.count}\n")
            else:
                fh.write("\n")


def write_incumb(path: str, result: RunResult) -> None:
    """incumb.dat: incumbent vector per replication (inout.c:26-31)."""
    with open(path, "w") as fh:
        for r in result.replications:
            fh.write(" ".join(f"{v:.6f}" for v in r.incumb_x) + "\n")


def write_jsonl(path: str, result: RunResult) -> None:
    with open(path, "w") as fh:
        for r in result.replications:
            rec = {
                "rep": r.rep, "iterations": r.iterations,
                "lb_estimate": r.incumb_est, "optimal": r.optimal,
                "lp_count": r.lp_count, "pools": r.pool_sizes,
                "time_total": r.time_total, "quad_scalar": r.quad_scalar,
            }
            if r.eval is not None:
                rec["eval"] = r.eval._asdict()
            fh.write(json.dumps(rec) + "\n")


def print_optimization_summary(r: ReplicationResult, max_iter: int,
                               out=print) -> None:
    """Console summary (printOptimizationSummary, inout.c:42-59)."""
    out("\n------------------------------ Optimization ------------------------------")
    out(f"Algorithm                          : {ALGORITHM}")
    star = "*" if r.iterations >= max_iter else ""
    out(f"Number of iterations               : {r.iterations}{star}")
    out(f"Number of unique observations      : {r.unique_omegas}")
    out(f"Lower bound estimate               : {r.incumb_est:f}")
    out(f"Total time                         : {r.time_total:f}")
    if r.time_master >= 0:
        out(f"Total time to solve master         : {r.time_master:f}")
        out(f"Total time to solve subproblems    : {r.time_subprob:f}")
        out(f"Total time to verify optimality    : {r.time_opttest:f}")
        out(f"Total time for argmax operation    : {r.time_argmax:f}")
    out(f"LPs solved                         : {r.lp_count}")
    out(f"Pool sizes (omega/lambda/sigma)    : {r.pool_sizes['omega']}/"
        f"{r.pool_sizes['lam']}/{r.pool_sizes['sigma']}")


def decompose_summary(sp, out=None) -> str:
    """printDecomposeSummary equivalent (called into summary.dat and stdout
    at algo.c:33-34): stage split + randomness census of the decomposed
    problem."""
    f, s, rv = sp.first, sp.second, sp.rv
    lines = [
        f"Problem                            : {sp.name}",
        f"First stage  (rows x cols)         : {f.A.shape[0]} x {f.A.shape[1]}",
        f"Second stage (rows x cols)         : {s.D.shape[0]} x {s.D.shape[1]}",
        f"Random variables                   : {len(rv.omega_mean)} "
        f"(rhs={rv.nb}, transfer={rv.nC}, cost={rv.nd})",
        f"Lower bound on recourse            : {sp.lb:f} "
        f"({'trivial' if sp.lb_is_trivial else 'nontrivial'})",
    ]
    text = "\n".join(lines)
    if out:
        out(text)
    return text


def write_summary(path: str, result: RunResult, sp=None,
                  max_iter: int = 0) -> None:
    """summary.dat (opened at algo.c:31): decompose summary, per-replication
    optimization/evaluation sections, and the compromise/average epilogue
    (algo.c:78-96)."""
    bar = "=" * 100
    with open(path, "w") as fh:
        def out(s=""):
            fh.write(s + "\n")

        if sp is not None:
            out(decompose_summary(sp))
        for r in result.replications:
            out("\n" + bar)
            out(f"Replication-{r.rep + 1}")
            print_optimization_summary(r, max_iter or r.iterations + 1,
                                       out=out)
            if r.eval is not None:
                print_evaluation_summary(r.eval, out=out)
        if result.compromise_x is not None:
            out("\n" + bar)
            out("\n---------------------------- Compromise solution ----------------------------\n")
            out("x* = " + " ".join(f"{v:.6f}" for v in result.compromise_x))
            if result.compromise_eval is not None:
                print_evaluation_summary(result.compromise_eval, out=out)
            out("\n----------------------------- Average solution ------------------------------\n")
            out("x* = " + " ".join(f"{v:.6f}" for v in result.average_x))
            if result.average_eval is not None:
                print_evaluation_summary(result.average_eval, out=out)


def print_evaluation_summary(e: EvalResult, out=print) -> None:
    """Console summary (printEvaluationSummary, inout.c:61-71)."""
    out("\n------------------------------- Evaluation -------------------------------")
    out(f"Upper bound estimate               : {e.mean:f}")
    out(f"Error in estimation                : {e.error:f}")
    out(f"Confidence interval at 95%         : [{e.ci_low:f}, {e.ci_high:f}]")
    out(f"Number of observations             : {e.count}")


def write_all(output_dir: str, result: RunResult, sp=None,
              max_iter: int = 0) -> None:
    os.makedirs(output_dir, exist_ok=True)
    write_detailed_results(os.path.join(output_dir, "detailedResults.csv"),
                           result)
    write_incumb(os.path.join(output_dir, "incumb.dat"), result)
    write_jsonl(os.path.join(output_dir, "results.jsonl"), result)
    write_summary(os.path.join(output_dir, "summary.dat"), result, sp=sp,
                  max_iter=max_iter)
