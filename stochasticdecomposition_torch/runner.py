"""Replication driver: the ``algo()`` / ``solveCell()`` equivalent.

Reference: algo.c.  ``SDSolver`` stages one problem on the device and runs
MULTIPLE_REP replications: SD steps (core/step.py; SAMPLE_INCREMENT samples
each, CHECK_EVERY steps between two host gates) until the statistical stop
(pre-test, then the bootstrap full test, optimal.c) or MAX_ITER samples,
each followed by the out-of-sample evaluation of its incumbent when
EVAL_FLAG is set; then, with COMPROMISE_PROB, the compromise and the
average decisions (core/compromise.py), both evaluated.  A replication
draws from its own ``torch.Generator`` pair seeded from RUN_SEED, an
evaluation from one seeded from EVAL_SEED.  An infeasible subproblem sends
the replication into feasibility mode (core/feasibility.py); under
MASTER_TYPE 1/7 a branch-and-bound over the master's relaxations
(core/bnb.py) makes every candidate integral.  A replication can be
checkpointed and resumed (utils/checkpoint.py), can stream its metrics and
estimate its phase times (utils/metrics.py).  ``run(mesh=)`` spreads the
replications over the ranks of a ``torch.distributed`` run, one process per
card, and shards each replication's observation columns over its rep
group's obs ranks (parallel/).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from stochasticdecomposition_torch.config import (
    MASTER_MILP, MASTER_MIQP, SDConfig,
)
from stochasticdecomposition_torch.core.bnb import make_mip_master
from stochasticdecomposition_torch.core.compromise import (
    BatchEntry, batch_entry_from_state, solve_compromise,
    solve_compromise_mip,
)
from stochasticdecomposition_torch.core.cuts import max_cut_height
from stochasticdecomposition_torch.core.evaluate import (
    EvalResult, eval_generator, evaluate, make_eval_batch,
)
from stochasticdecomposition_torch.core.state import (
    Capacities, derive_capacities, estimate_pool_bytes, init_state,
    stage_problem,
)
from stochasticdecomposition_torch.core.feasibility import (
    resolve_infeasibility,
)
from stochasticdecomposition_torch.core.step import (
    lp_master, make_step, make_substeps, problem_path,
)
from stochasticdecomposition_torch.core.stopping import (
    bootstrap_draws, full_test, pre_test,
)
from stochasticdecomposition_torch.device import resolve_device
from stochasticdecomposition_torch.ops.simplex import (
    STATUS_OPTIMAL, lane, solve_lp,
)
from stochasticdecomposition_torch.parallel.distributed import (
    obs_max, obs_min,
)
from stochasticdecomposition_torch.prob import (
    StagedProblem, attach_stoc, decompose,
)
from stochasticdecomposition_torch.sampler import build_sampler
from stochasticdecomposition_torch.smps import read_smps
from stochasticdecomposition_torch.utils.checkpoint import (
    load_checkpoint, save_state, wave_path,
)
from stochasticdecomposition_torch.utils.metrics import estimate_phase_times


def lockstep_digest(state) -> torch.Tensor:
    """What the obs ranks of one replication must hold bit for bit: k, the
    pool counts and the incumbent's bits (int64, on the host)."""
    counts = torch.tensor([state.k, state.omega_cnt, state.lambda_cnt,
                           state.sigma_cnt, state.cut_cnt])
    return torch.cat([counts, state.incumb_x.cpu().view(torch.uint8).long()])


def check_lockstep(state) -> None:
    """Raise on every obs rank of a sharded replication when its ranks no
    longer step alike (each takes its host decisions from values that must
    be bit-identical across them, or they would part in a collective)."""
    if state.shard is None:
        return
    d = lockstep_digest(state)
    if not torch.equal(obs_min(d, state.shard), obs_max(d, state.shard)):
        raise RuntimeError(
            f"the obs ranks of this replication are out of lockstep at "
            f"k={state.k}: their k, pool counts or incumbents differ")


def check_pool_overflow(omega_cnt: int, lambda_cnt: int, sigma_cnt: int,
                        caps: Capacities, rep: int | None = None) -> None:
    """Pool-overflow detection: an overflowed omega pool corrupts the
    sample stream (raise); overflowed lambda/sigma pools only weaken cuts
    (warn)."""
    tag = "" if rep is None else f"replication {rep}: "
    if omega_cnt > caps.O:
        raise RuntimeError(
            f"{tag}omega pool overflowed its capacity ({omega_cnt} > "
            f"{caps.O}): observations past capacity were dropped, "
            "corrupting the sample stream.  Raise MAX_OMEGA.")
    if lambda_cnt > caps.L or sigma_cnt > caps.S:
        warnings.warn(
            f"{tag}dual-vertex pools overflowed (lambda {lambda_cnt}/"
            f"{caps.L}, sigma {sigma_cnt}/{caps.S}): vertices past "
            "capacity were dropped.  Cuts remain valid lower bounds but "
            "are weaker; raise MAX_LAMBDA/MAX_SIGMA for full strength.",
            RuntimeWarning, stacklevel=3)


@dataclasses.dataclass
class ReplicationResult:
    rep: int
    iterations: int
    incumb_x: np.ndarray
    incumb_est: float           # lower-bound estimate at termination
    optimal: bool               # stopped by the statistical test (vs MAX_ITER)
    lp_count: int
    unique_omegas: int
    pool_sizes: dict
    time_total: float
    time_setup: float
    quad_scalar: float = 0.0
    cuts_active: int = 0
    full_tests: int = 0
    lp_pivots: int = 0          # simplex pivots over all subproblem solves
    qp_iters: int = 0           # interior-point iterations over all masters
    master_failures: int = 0    # uncertified master solves (run continued)
    cuts_formed: int = 0        # SD cuts formed (argmax calls)
    feas_rounds: int = 0        # feasibility-mode rounds
    eval: Optional[EvalResult] = None
    batch_entry: Optional[BatchEntry] = None   # compromise artifacts (host)
    # Per-phase seconds (runTime analog, twoSD.h:87-99): estimates from
    # utils/metrics.estimate_phase_times when the run asked for them
    # (``time_phases``); -1 = not measured.
    time_master: float = -1.0
    time_subprob: float = -1.0
    time_opttest: float = -1.0
    time_argmax: float = -1.0


@dataclasses.dataclass
class RunResult:
    problem: str
    replications: List[ReplicationResult]
    compromise_x: Optional[np.ndarray] = None
    average_x: Optional[np.ndarray] = None
    compromise_eval: Optional[EvalResult] = None
    average_eval: Optional[EvalResult] = None


def mean_value_solution(sp: StagedProblem, device: torch.device,
                        dtype=torch.float64) -> np.ndarray:
    """Solve the deterministic mean-value LP; its first-stage part seeds the
    initial candidate/incumbent (meanProblem at setup.c:21, used as xk)."""
    f, s = sp.first, sp.second
    m1, n1 = f.A.shape
    m2, n2 = s.D.shape
    A = np.zeros((m1 + m2, n1 + n2))
    A[:m1, :n1] = f.A
    A[m1:, :n1] = s.C_bar
    A[m1:, n1:] = s.D
    b = np.concatenate([f.b, s.b_bar])
    sense = np.concatenate([f.sense, s.sense]).astype(np.int64)
    c = np.concatenate([f.c, s.d_bar])
    lo = np.concatenate([f.lb, s.lb])
    hi = np.concatenate([f.ub, s.ub])

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    out = lane(solve_lp(t(A), t(sense, torch.int64), t(c)[None], t(lo),
                        t(hi), t(b)[None],
                        max_iter=12 * (A.shape[0] + A.shape[1]) + 256), 0)
    if int(out.status) != STATUS_OPTIMAL:
        raise RuntimeError(
            f"mean-value problem not optimal (status {int(out.status)})")
    return out.y[:n1].cpu().numpy()


def replication_generators(seed: int, device: torch.device):
    """Two independent generators from one RUN_SEED: observations, and the
    bootstrap's resampling."""
    gens = []
    for child in np.random.SeedSequence(int(seed)).spawn(2):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return gens


class SDSolver:
    """Solver bound to one staged problem, configuration and device.

    ``device=None`` runs on the CUDA card and raises if there is none; the
    CPU must be asked for (``device="cpu"``)."""

    def __init__(self, sp: StagedProblem, cfg: SDConfig, device=None,
                 dtype=torch.float64):
        self.device = resolve_device(device)
        self.sp = sp
        self.cfg = cfg
        if cfg.LOWER_BOUND is not None:
            sp.lb = float(cfg.LOWER_BOUND)
            sp.lb_is_trivial = sp.lb == 0.0
        stoc = getattr(sp, "_stoc", None)
        if stoc is None:
            raise ValueError(
                "StagedProblem lacks attached stoch data; use prob.attach_stoc "
                "so the sampler can be built")
        self.pa = stage_problem(sp, self.device, dtype)
        self.spec = build_sampler(stoc, sp.rv_order, self.device)
        self.step = make_step(self.pa, self.spec, cfg)
        self.substeps = make_substeps(self.pa, cfg)
        self.reform = problem_path(self.pa).reform
        # MILP/MIQP master (MASTER_TYPE 1/7) on an integer first stage: the
        # step solves the continuous relaxation (its duals feed the cut
        # eviction and the bootstrap), then the branch-and-bound makes the
        # candidate integral (master.c:41 semantics).  Without integer
        # columns the master is the plain LP or QP.
        self.mip_master = None
        if cfg.MASTER_TYPE in (MASTER_MILP, MASTER_MIQP) and \
                bool(torch.any(self.pa.int1)):
            self.mip_master = make_mip_master(self.pa, cfg)
        self.caps = derive_capacities(sp, cfg)
        self.pool_bytes = estimate_pool_bytes(sp, self.caps, cfg)
        self.mean_sol = mean_value_solution(sp, self.device, dtype)
        self.eval_batch_fn = None
        self._eval_batch = 0

    def solve_replication(self, rep: int = 0, log=lambda s: None,
                          checkpoint_every: int = 0,
                          checkpoint_dir: str | None = None,
                          resume_from: str | None = None,
                          metrics=None, time_phases: bool = False,
                          wave_start: int | None = None, shard=None
                          ) -> ReplicationResult:
        """One replication to the certified stop or MAX_ITER samples.

        ``metrics``, if given, has its ``record(state)`` called after every
        call of the step.  With ``checkpoint_every`` and ``checkpoint_dir``
        the state and the host loop's state are saved to
        ``rep{rep:02d}_k{k:06d}.npz`` whenever k has advanced by at least
        ``checkpoint_every`` samples since the last save (elapsed k, so that
        batched strides do not skip saves), at the end of a loop pass;
        ``resume_from`` continues from such a file.  ``time_phases`` fills
        the result's phase times (utils/metrics.estimate_phase_times).
        ``wave_start`` (the meshed runner, parallel/runner.py) names the
        checkpoints ``utils/checkpoint.wave_path(dir, wave_start, rep, k)``,
        records the wave in them, and adds the replication's ``_final``
        file when it ends.  ``shard`` (``parallel/distributed.ObsShard``,
        from the meshed runner) holds this rank's observation columns: every
        obs rank of the group calls this at once, and they check after a
        resume, at every full test and at the end that they still step
        alike (``check_lockstep``); they save at the same k, and obs rank 0
        writes the one file, at the full width (utils/checkpoint.py)."""
        cfg = self.cfg
        t0 = time.monotonic()
        gen, boot_gen = replication_generators(cfg.RUN_SEED[rep], self.device)
        state = init_state(self.pa, self.caps, cfg, self.mean_sol, shard)
        pool_alpha, pool_beta = [], []      # the feasibility cut pool
        n_full_tests = 0
        master_fails = 0
        master_failures = 0
        if resume_from:
            state, extras = load_checkpoint(resume_from, state)
            if "generators" in extras:
                if extras["device_type"] != self.device.type:
                    raise ValueError(
                        f"checkpoint {resume_from} holds "
                        f"{extras['device_type']} generator states; this "
                        f"solver runs on {self.device.type}")
                gen.set_state(extras["generators"][0])
                boot_gen.set_state(extras["generators"][1])
            if "pool_alpha" in extras:
                pool_alpha = extras["pool_alpha"]
                pool_beta = extras["pool_beta"]
            else:
                # No pool saved: reset the watermarks so update_feas_cut_pool
                # rebuilds it from the restored sigma/delta pools.
                state = state._replace(f_updt=(0, 0))
            n_full_tests = extras.get("n_full_tests", 0)
            master_failures = extras.get("master_failures", 0)
            master_fails = extras.get("master_fails", 0)
            # The obs ranks of a sharded replication read one file.
            check_lockstep(state)
        t_setup = time.monotonic() - t0
        last_ckpt_k = state.k

        def save(k, **extra):
            # k None: the meshed runner's _final file.
            if wave_start is None:
                path = os.path.join(checkpoint_dir,
                                    f"rep{rep:02d}_k{k:06d}.npz")
            else:
                path = wave_path(checkpoint_dir, wave_start, rep, k)
                extra["wave_start"] = wave_start
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_state(path, state, generators=(gen, boot_gen),
                       pool_alpha=pool_alpha, pool_beta=pool_beta,
                       counters=dict(n_full_tests=n_full_tests,
                                     master_failures=master_failures,
                                     master_fails=master_fails, **extra))

        # LP and MILP masters have no bootstrap lower bound (fullTest aborts
        # at optimal.c:104-108): they run to MAX_ITER.  MIQP keeps the
        # statistical stop on its relaxation's duals.
        stat_stop = not lp_master(cfg)
        optimal = False
        while state.k < cfg.MAX_ITER:
            k = state.k
            # Optimality gate (optimal.c:23-42): min iterations + stable duals
            # + pre-test, then the bootstrap full test.
            if stat_stop and k > cfg.MIN_ITER and state.dual_stable and \
                    pre_test(float(state.candid_est),
                             float(state.incumb_est), cfg.PRE_EPSILON):
                n_full_tests += 1
                check_lockstep(state)
                draws = bootstrap_draws(state, boot_gen, cfg.BOOTSTRAP_REP)
                if full_test(self.pa, cfg, state, draws, self.reform):
                    optimal = True
                    log(">")
                    break
                log(".")
            state = self.step(state, gen)
            if metrics is not None:
                metrics.record(state)
            if not state.sp_feas:
                # Feasibility mode (resolveInfeasibility, cuts.c:402-449).
                log("F")
                state, pool_alpha, pool_beta = resolve_infeasibility(
                    self.pa, state, cfg, self.substeps, pool_alpha, pool_beta)
            if not state.cut_ok and state.sp_feas:
                # istar < 0: the hard error of the reference (cuts.c:136-139).
                raise RuntimeError(
                    f"SD cut formation failed at k={state.k}: no valid "
                    "dual vertex for some observation")
            if not state.master_ok:
                # Continue with the uncertified iterate (still a feasible
                # d-space point); raise only when certification fails for
                # 5 consecutive iterations, as the JAX package does.
                master_fails += 1
                master_failures += 1
                log("!")
                if master_fails >= 5:
                    raise RuntimeError(
                        f"master QP failed to converge at k={state.k} "
                        "(5 consecutive iterations)")
                state = state._replace(master_ok=True)
            else:
                master_fails = 0
            if self.mip_master is not None:
                state = self._mip_commit(state, log)
            if k % 100 == 0:
                log(f"\nIteration-{k:4d}: ")
            # Saved after the pass's feasibility, master and B&B handling,
            # so a resume starts where the next pass would.
            if checkpoint_every and checkpoint_dir and \
                    state.k - last_ckpt_k >= checkpoint_every:
                last_ckpt_k = state.k
                save(state.k)

        if self.mip_master is not None:
            # The incumbent starts at the (possibly fractional) mean-value
            # solution; if no integral candidate ever replaced it, report
            # the last integral candidate.
            ii = torch.nonzero(self.pa.int1)[:, 0]
            xi = state.incumb_x[ii]
            if float(torch.amax(torch.abs(xi - torch.round(xi)))) > 1e-6:
                state = state._replace(incumb_x=state.candid_x.clone(),
                                       incumb_est=state.candid_est.clone())

        check_lockstep(state)
        if wave_start is not None and checkpoint_every and checkpoint_dir:
            save(None, optimal=int(optimal))
        result = self._result(state, rep, optimal, n_full_tests,
                              master_failures, time.monotonic() - t0, t_setup)
        if time_phases:
            # On copies of the final state, after the result is read: the
            # timed pieces grow the pools of the state they are given.
            result = dataclasses.replace(result, **estimate_phase_times(
                self, state, iterations=state.k, lp_count=state.lp_cnt,
                full_tests=n_full_tests, tau=cfg.TAU))
        return result

    def replication_from_file(self, path: str, rep: int) -> ReplicationResult:
        """The result of replication ``rep`` rebuilt from its ``_final``
        file (the meshed runner's), with times 0."""
        state, extras = load_checkpoint(path, init_state(
            self.pa, self.caps, self.cfg, self.mean_sol))
        return self._result(state, rep, bool(extras["optimal"]),
                            extras["n_full_tests"], extras["master_failures"],
                            0.0, 0.0)

    def _result(self, state, rep, optimal, n_full_tests, master_failures,
                time_total, time_setup) -> ReplicationResult:
        check_pool_overflow(state.omega_cnt, state.lambda_cnt,
                            state.sigma_cnt, self.caps, rep)
        n_cuts = int(torch.sum(state.cut_mask))
        return ReplicationResult(
            rep=rep,
            iterations=state.k,
            incumb_x=state.incumb_x.cpu().numpy(),
            incumb_est=float(state.incumb_est),
            optimal=optimal,
            lp_count=state.lp_cnt,
            unique_omegas=state.omega_cnt,
            pool_sizes=dict(omega=state.omega_cnt, lam=state.lambda_cnt,
                            sigma=state.sigma_cnt, cuts=n_cuts),
            time_total=time_total,
            time_setup=time_setup,
            quad_scalar=float(state.quad_scalar),
            cuts_active=n_cuts,
            full_tests=n_full_tests,
            lp_pivots=state.lp_pivots,
            qp_iters=state.qp_iters,
            master_failures=master_failures,
            cuts_formed=state.cut_cnt,
            feas_rounds=state.feas_cnt,
            batch_entry=batch_entry_from_state(state),
        )

    def _mip_commit(self, state, log):
        """The integer master (MASTER_TYPE 1/7): the branch-and-bound over
        the master's relaxations replaces the candidate with the integral
        optimum of the same master; the relaxation's duals stay in the
        state.  MILP, in LP mode, reports the candidate as the solution."""
        pa = self.pa
        res = self.mip_master(state)
        if not res.found:
            if res.uncertified:
                raise RuntimeError(
                    f"B&B master: node relaxations failed to certify at "
                    f"k={state.k} ({res.uncertified} of {res.nodes} nodes "
                    "uncertified after retry)")
            raise RuntimeError(
                f"B&B master found no integer-feasible point at k={state.k} "
                f"({res.nodes} nodes explored)")
        if res.truncated:
            log(f"\n[warn] B&B master hit its node limit at k={state.k} "
                f"({res.nodes} nodes); integral candidate may be "
                "suboptimal\n")
        x = torch.as_tensor(res.x, dtype=pa.c1.dtype, device=pa.c1.device)
        est = pa.c1 @ x + max_cut_height(pa, state, x, state.k)
        state = state._replace(candid_x=x, candid_est=est,
                               gamma=est - state.incumb_est)
        if lp_master(self.cfg):
            state = state._replace(incumb_x=x.clone(), incumb_est=est.clone(),
                                   gamma=torch.zeros_like(est))
        return state

    def evaluate_x(self, x, rep: int = 0, **kw) -> EvalResult:
        """Out-of-sample estimate of c'x + E[h(x, omega)] on draws from
        EVAL_SEED[rep]; ``kw`` goes to ``core/evaluate.evaluate``.  The
        batch function is kept across calls (it keeps the mean observation's
        basis) and built again when EVAL_BATCH changes."""
        batch = self.cfg.EVAL_BATCH
        if self.eval_batch_fn is None or self._eval_batch != batch:
            self.eval_batch_fn = make_eval_batch(self.pa, self.spec, batch)
            self._eval_batch = batch
        gen = eval_generator(self.cfg.EVAL_SEED[rep], self.device)
        return evaluate(self.pa, self.spec, self.cfg, x, gen,
                        eval_batch_fn=self.eval_batch_fn, **kw)

    def run(self, log=lambda s: None, checkpoint_every: int = 0,
            checkpoint_dir: str | None = None,
            resume_from: str | None = None, time_phases: bool = False,
            metrics=None, mesh=None) -> RunResult:
        """The run of ``algo()`` (algo.c:36-96): MULTIPLE_REP replications,
        each evaluated on EVAL_SEED[rep] when EVAL_FLAG is set, then with
        COMPROMISE_PROB the compromise and the average decisions, both
        evaluated on EVAL_SEED[0].  ``resume_from`` applies to replication
        0.  ``metrics`` is a recorder given every replication's states, or
        a callable ``rep -> recorder`` whose recorder takes that
        replication's states and is closed after it (the CLI's
        ``metrics_repNN.jsonl``).

        ``mesh`` (``parallel/mesh.make_mesh``): every rank of the mesh
        calls ``run``; the replications run in waves over its rep groups
        (``parallel/runner.run_replications_meshed``, ``resume_from`` a
        file of the wave to resume) and every rank returns them all.  The
        evaluation, the compromise and the average run on the coordinator
        only; the other ranks' ``compromise_x`` is None.  As in the JAX
        package, the meshed path takes no metrics and no phase times, and
        no MILP/MIQP master."""
        cfg = self.cfg
        coord = True
        if mesh is not None:
            if self.mip_master is not None:
                raise ValueError(
                    "MILP/MIQP masters run on the sequential path only "
                    "(the branch-and-bound is a per-iteration host loop); "
                    "drop --mesh")
            if metrics is not None or time_phases:
                raise ValueError(
                    "the meshed path takes no metrics and no phase times")
            from stochasticdecomposition_torch.parallel.distributed import (
                is_coordinator,
            )
            from stochasticdecomposition_torch.parallel.runner import (
                run_replications_meshed,
            )
            coord = is_coordinator()
            reps = run_replications_meshed(
                self, mesh, log=log, checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir, resume_from=resume_from)
            if cfg.EVAL_FLAG and coord:
                for r in reps:
                    r.eval = self.evaluate_x(r.incumb_x, r.rep)
        else:
            reps = self._run_sequential(log, checkpoint_every,
                                        checkpoint_dir, resume_from,
                                        time_phases, metrics)
        result = RunResult(problem=self.sp.name, replications=reps)

        if cfg.COMPROMISE_PROB and len(reps) > 1 and coord:
            entries = [r.batch_entry for r in reps]
            # Integer mode: the reference applies MASTER_TYPE to the batch
            # problem too (compromise.c:260).
            solve = solve_compromise if self.mip_master is None else \
                solve_compromise_mip
            result.compromise_x, result.average_x = solve(self.pa, entries)
            if cfg.EVAL_FLAG:
                result.compromise_eval = self.evaluate_x(
                    result.compromise_x, 0)
                result.average_eval = self.evaluate_x(result.average_x, 0)
        return result

    def _run_sequential(self, log, checkpoint_every, checkpoint_dir,
                        resume_from, time_phases, metrics):
        cfg = self.cfg
        per_rep = metrics is not None and not hasattr(metrics, "record")
        reps = []
        for rep in range(cfg.MULTIPLE_REP):
            rec = metrics(rep) if per_rep else metrics
            try:
                r = self.solve_replication(
                    rep, log=log, checkpoint_every=checkpoint_every,
                    checkpoint_dir=checkpoint_dir,
                    resume_from=resume_from if rep == 0 else None,
                    metrics=rec, time_phases=time_phases)
            finally:
                if per_rep:
                    rec.close()
            if cfg.EVAL_FLAG:
                r.eval = self.evaluate_x(r.incumb_x, rep)
            reps.append(r)
        return reps


def solve_smps(input_dir: str, prob_name: str,
               cfg: Optional[SDConfig] = None, device=None,
               log=lambda s: None) -> RunResult:
    """End-to-end entry: read the SMPS triplet, decompose, run (twoSD.c
    main).  ``device=None`` is the CUDA card."""
    core, tim, stoc = read_smps(input_dir, prob_name)
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    return SDSolver(sp, cfg or SDConfig(), device=device).run(log=log)
