"""Per-iteration metrics stream, phase-time estimates and step profiles.

Reference: the hand-rolled runTime phase timers (twoSD.h:87-99) written to
detailedResults.csv.  The port of the JAX package's ``utils/metrics.py``:
``MetricsRecorder`` writes the same JSONL records (k, estimates, gamma,
quadScalar, pool sizes, stability); ``estimate_phase_times`` times the
step's pieces on the final state and scales them by their call counts;
``profile_steps`` traces a window of steps with ``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from stochasticdecomposition_torch.core.stopping import (
    bootstrap_draws, full_test,
)

SAMPLES = 5             # timed calls of each piece in estimate_phase_times


class MetricsRecorder:
    def __init__(self, path: Optional[str] = None, every: int = 1):
        self.path = path
        self.every = max(1, every)
        self._fh = open(path, "w") if path else None
        self._last_t = time.monotonic()

    def record(self, state) -> None:
        k = int(state.k)
        if k % self.every or self._fh is None:
            return
        now = time.monotonic()
        rec = {
            "k": k,
            "candid_est": float(state.candid_est),
            "incumb_est": float(state.incumb_est),
            "gamma": float(state.gamma),
            "quad_scalar": float(state.quad_scalar),
            "omega_cnt": int(state.omega_cnt),
            "lambda_cnt": int(state.lambda_cnt),
            "sigma_cnt": int(state.sigma_cnt),
            "cuts": int(torch.sum(state.cut_mask)),
            "dual_stable": bool(state.dual_stable),
            "dt": now - self._last_t,
        }
        self._last_t = now
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def clone_state(state):
    """A copy of ``state`` whose tensors share no storage with it (the
    pools are updated in place)."""
    return state._replace(**{
        f: v.clone() for f, v in state._asdict().items()
        if isinstance(v, torch.Tensor)})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def estimate_phase_times(solver, state, *, iterations: int, lp_count: int,
                         full_tests: int, tau: int) -> dict:
    """Per-phase second estimates for the runTime columns (twoSD.h:87-99).

    Each piece of the step (core/step.py ``make_substeps``) and the full
    test is called on a fresh copy of the FINAL state — the pieces grow the
    pools and the cut count of the state they are given — once to warm up
    and then SAMPLES times, each call between two synchronisations of the
    card, and its mean time is scaled by the phase's call count, as the
    JAX package does:
      * master   = t(master_step)    x iterations
      * subprob  = t(subprob_update) x LP count  (includes the per-solve
                   stochastic updates, which the reference books under
                   argmax)
      * argmax   = t(cut_step)       x cut formations (candidate + TAU-cycle
                   incumbent cuts)
      * opttest  = t(full_test)      x full tests run
    Final-state pools are the largest of the run, so these are conservative
    (upper) estimates of the per-phase averages.  ``cut_step`` launches the
    argmax kernel 1 + SAMPLES times on the plain path."""
    dev = state.candid_x.device

    def t_of(fn):
        fn(clone_state(state))
        total = 0.0
        for _ in range(SAMPLES):
            s = clone_state(state)
            _sync(dev)
            t0 = time.monotonic()
            fn(s)
            _sync(dev)
            total += time.monotonic() - t0
        return total / SAMPLES

    sub = solver.substeps
    t_master = t_of(sub["master_step"])
    t_subprob = t_of(sub["subprob_update"])
    t_cut = t_of(sub["cut_step"])
    t_opt = 0.0
    if full_tests:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def one_test(s):
            draws = bootstrap_draws(s, gen, solver.cfg.BOOTSTRAP_REP)
            return full_test(solver.pa, solver.cfg, s, draws, solver.reform)

        t_opt = t_of(one_test)

    n_cut_calls = iterations * (1.0 + 1.0 / max(tau, 1))
    return {
        "time_master": t_master * iterations,
        "time_subprob": t_subprob * lp_count,
        "time_argmax": t_cut * n_cut_calls,
        "time_opttest": t_opt * full_tests,
    }


def profile_steps(step_fn, state, gen, n: int, trace_dir: str):
    """Run ``n`` SD steps under ``torch.profiler`` (CPU and, on the card,
    CUDA activities) and write the trace to ``trace_dir/trace.json``;
    returns the state after the steps."""
    from torch.profiler import ProfilerActivity, profile

    dev = state.candid_x.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        for _ in range(n):
            state = step_fn(state, gen)
        _sync(dev)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return state
