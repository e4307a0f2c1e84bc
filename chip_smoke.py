"""Drive the PyTorch port of SD on one CUDA card, phase by phase.

    python3 chip_smoke.py

(``python3 chip_smoke.py --mesh-rank DIR`` is one rank of phase 16 and
``--obs-rank DIR`` one of phase 17, started by torchrun; see there.  Each
joins the process group before its CLI run and leaves it,
``parallel/distributed.shutdown``, after its last collective.)

Each phase prints one JSON line with its seconds; any failure exits non-zero
(nothing is swallowed).  Phases:

  0. device   — requires CUDA; the card's name and power limit (nvidia-smi),
                torch and CUDA versions.
  1. build    — builds the kernel library from csrc/ with nvcc if missing.
 1b. smps_native — builds the native SMPS tokenizer (smps/native.py, g++)
                and parses the core text of every models/instances.py
                instance and of stormlike (528 x 1259 second stage) with it
                and with the pure-Python parser: every field equal; the
                seconds of each reader.
  2. kernel   — the triple masked argmax kernel against its plain PyTorch
                version on f64 data from a numpy seed, at the main path's
                shapes up to the default (7501, 5120): random masks, empty
                masks, all-equal H and NaN, and the edge cases of
                ops/argmax_cases.py (pool prefixes of 64 and 512 rows, a
                selected -inf, selected -1e300, NaN in unselected rows, NaN
                and ties across split boundaries, a row tile and a split no
                mask selects), under the default split and, at (3000, 1024),
                under 2 and 40 S-splits and with cp.async copies, and at one
                obs rank's columns of the default table over 2 and 4 ranks
                (7501, 2560), (7501, 1280) and at an odd width (7501, 2561):
                all six outputs must be equal.  Timed at (7501, 5120) with
                random masks (the full table), with the pool prefixes and
                at the three shard widths: the median of 30
                launches, each between its own CUDA events after a 512 MB
                write that flushes L2 and a spin that keeps the card ahead
                of the host, beside the bytes bound of the rows the masks
                select; one case cross-checked with
                torch.profiler's device time of the kernel.
  3. lands    — batch-1 SD at the default SDConfig (MAX_ITER=5000 pool
                capacities, no evaluation) to the certified stop; exact gap
                of the incumbent against the extensive-form optimum.  With
                a checkpoint every CKPT_EVERY samples (in a temporary
                directory); then the replication resumed from the last
                checkpoint must return the same iterations, incumbent (bit
                for bit), estimate, pools and cuts (``resume_identical``),
                launching the kernel once per cut formed after it.
                The checkpoints' write time and bytes are reported apart
                (``checkpoint_seconds``, ``sd_seconds_without_checkpoints``).
  4. pgp2like — the same, without checkpoints.
  5. stormlike — default capacities, a fixed 6 iterations: every LP
                optimal, every cut and master solve certified.  (12 before
                phase 19, which adds 3-4 minutes on an H100 and took the
                whole script there to 1068 s of its 1200 s limit; phase 19
                runs stormlike to the certified stop at SAMPLE_INCREMENT
                64.)
  6. randc    — random technology coefficients (parse_synthetic with
                rand_C=2) at the default capacities to the certified stop:
                the [L, O, 2] delta_piC table (614 MB), peak memory, exact
                gap against the extensive form.
  7. lands_b16, pgp2like_b64 — SAMPLE_INCREMENT 16 and 64 to the certified
                stop through ``SDSolver.run`` with EVAL_FLAG on (the
                evaluation is reported by phase 9); pool capacities from the
                finite support, MAX_ITER (samples) raised so a stop is in
                reach; exact gap.
  8. stormlike_b8 — 6 steps at SAMPLE_INCREMENT 8 at full width: seconds
                per step, LPs/s, pivots per LP and per lane (max, median);
                every master certified.  Then a second replication
                (RUN_SEED[1]) of the same steps and the compromise of the
                two (n1 = 121, 59 first-stage rows): the batch QP must
                certify on the card, and the compromise decision meet the
                first-stage rows and bounds within COMPROMISE_VIOLATION;
                its IPM iterations and seconds.
  9. eval     — the upper-bound estimates of phase 7's runs (within 1 % of
                the incumbent's exact objective) and a fixed 2 x 512 lanes
                on the stormlike_b8 incumbent: UB, CI, count, dropped
                lanes, LPs/s and pivots/s.
 10. feastest — feasibility mode at the default capacities, FEAS_ITERS
                iterations (the bootstrap lower bound leaves out the
                feasibility cuts, so feastest has no certified stop in
                either package): feasibility rounds > 0, the incumbent meets
                x1 + x2 >= 6, exact gap; launches count the cuts formed
                after each resolve.
 11. fleetminilike — random cost coefficients (81 enumerable scenarios) at
                the default capacities to the certified stop: exact gap,
                basis pool, peak memory, no argmax kernel launch (the
                random-cost cut uses triple_argmax_randcost); on the final
                state the blockwise random-cost argmax equals the
                materialized [B, O] table's masked max (heights exactly,
                indices up to equal heights), and its time per cut.
 12. baa99-20like — random costs (20 RHS RVs, 4 cost RVs, second stage
                40 x 60) at the default capacities, to the certified stop or
                BAA_ITERS iterations: seconds per iteration, basis pool, the
                blockwise check, and STOCH_CHECK: on 32 stored observations
                every valid random-cost height at the final candidate is at
                most the subproblem's optimal value + 1e-6.
 13. lands_lp — the LP master (MASTER_TYPE 0), LP_ITERS iterations: no
                statistical stop, and the evaluated UB within 2 % of the
                extensive-form optimum.
 14. intcaplike_miqp — the MIQP master (MASTER_TYPE 7), MAX_ITER 120,
                MIN_ITER 40, two replications and the integer compromise
                through ``SDSolver.run``: each incumbent and the compromise
                are integral and their exact costs within 1 % of the
                integer optimum found by enumerating the integer grid;
                branch-and-bound nodes and waves per iteration, the
                compromise's nodes and IPM iterations.
 15. cli_pgp2like_m3 — ``cli.main(["-p", "pgp2like", "-m", "3", "-c", "1",
                "-e", "1", "--metrics-every", "10", "--time-phases", ...])``
                in process at the default capacities: three certified stops
                within the exact-gap limit, the compromise within it too,
                the compromise's and the average's UBs within 1 % of their
                exact objectives, the result files (phase columns >= 0, the
                compromise and average sections, three metrics streams);
                launches = cuts formed + (1 + SAMPLES) per replication for
                the phase-time estimate's ``cut_step`` calls.
 16. cli_pgp2like_m3_mesh — the same run over three ranks that share the
                card: ``python -m torch.distributed.run --standalone
                --nproc_per_node 3 chip_smoke.py --mesh-rank DIR``, each
                rank calling ``cli.main([... "--mesh", "3x1",
                "--distributed", "-o", DIR/rankR])`` (no metrics, no phase
                times) and then the sharded evaluation of MESH_EVAL_LANES
                lanes on replication 0's incumbent.  Against phase 15's
                results: iterations, certification, unique omegas and pool
                sizes equal, incumbents and estimates within 1e-8 (whether
                bit-identical is reported), the compromise and the average
                within 1e-6, every UB within 1e-8; result files under rank
                0's directory only; every rank on the card, its launches =
                the cuts of its replication; the sharded evaluation equal
                to ``make_eval_batch`` (n_ok exact, mean within 1e-10, M2
                within 1e-8, relative).  Seconds, launches and peak memory
                per rank.
 17. pgp2like_obs2, lands_b16_obs2, spread_obs2, spread_b16_obs2 — one
                replication's pools split over two ranks that share the
                card (``python -m torch.distributed.run --standalone
                --nproc_per_node 2 chip_smoke.py --obs-rank DIR``, a 1x2
                mesh): pgp2like at the default capacities to the certified
                stop through ``cli.main([... "--mesh", "1x2",
                "--distributed"])``, held to phase 4; through
                ``SDSolver.run``, each held to the same run unsharded, made
                first in this process: lands at SAMPLE_INCREMENT 16 on the
                default capacities (O = 5120), and the synthetic ``spread``
                instance (SPREAD: almost every draw a new observation, so
                that both ranks' columns fill) at MAX_ITER 300 (O = 384)
                and at the default capacities with SAMPLE_INCREMENT 16 and
                MIN_ITER SPREAD_B16_MIN samples (more than 2560 distinct
                observations: rank 1's block of O = 5120 fills).  Each
                rank: the iterations, certification, unique omegas and pool
                sizes equal, incumbent and estimate within 1e-8 (whether
                bit-identical is reported), launches = cuts formed, its
                state's observation-axis bytes half the unsharded state's,
                its seconds and peak memory, and the wall seconds and calls
                of its obs collectives (``parallel/distributed.py``'s
                ``obs_seconds``, ``obs_calls``), also per step;
                pgp2like's exact gap within GAP_LIMIT and its files on rank
                0 only.
     fleetminilike_obs2, baa99-20like_obs2 — random costs over the same
                1x2 mesh (``obs_feas`` split like the observation columns),
                phases 11 and 12's configurations held to their
                replications by the same rules, with no kernel launch and
                the blockwise random-cost argmax held against its
                materialized table on each rank's final state.
     spread_b16_obs2_resume — spread_b16_obs2 writes a checkpoint every
                CKPT_EVERY samples (obs rank 0 gathers the ranks' columns
                into one file; each rank's ``save_state`` seconds and the
                files' bytes are reported); the last one resumed over the
                1x2 mesh must give the uninterrupted sharded run bit for
                bit, and resumed on a 1x1 mesh in this process within 1e-8,
                each launching the kernel once per cut formed after it.
 18. partial_pricing — stormlike's second-stage LP (528 x 1259) at the
                stormlike_b8 incumbent, with and without ``solve_lp``'s
                ``partial_pricing``: PP_LANES (8 and 512) lanes of drawn
                observations warm from the mean observation's basis (phase
                9's); the same statuses and objectives within
                PP_OBJ_RTOL; pivots per LP and seconds of each, beside the
                card's name and power limit; the result fields in which the
                first 8 lanes' bits differ between the two lane counts.
                (It runs right after phase 9, on phase 8's solver.)
 19. suite    — the experiment drivers, after phase 17.
     stormlike_b64_stop, ssnlike_b64_stop — ``suite_to_stop.run`` (the
                port's scripts/suite_to_stop.py) at SAMPLE_INCREMENT 64,
                tolerance l, CHECK_EVERY 4, pools derived from MAX_ITER
                4096, then its steady rate (3 untimed and 5 timed calls of
                the step from a fresh state): a statistical stop, no
                uncertified master, launches = the cuts formed in both
                runs; the kernel on the final height table (argmax_at_stop);
                the incumbent evaluated on 512 observations (EVAL_ERROR 0):
                a finite UB, no lane dropped, within EVAL_LIMIT of the LB
                estimate.  Samples to stop, pools, cuts, quad_scalar, SD
                seconds, samples/s (to the stop and steady), seconds and
                lane pivots (max, median) per call of the step, pivots per
                LP, the state's bytes beside ``estimate_pool_bytes``, peak
                memory, the card's name and power limit.
     sweep_grid — ``sweep.main`` (the port's root sweep.py) in process on
                cep1like and baa99like, tolerance n, SAMPLE_INCREMENT 1 and
                16, no evaluation, ``--parity 100000``: four rows, each
                certified with its exact gap within GAP_LIMIT, no ERROR
                row, both files parsed, launches = cuts formed; then the
                (cep1like, n, 16) row again in a fresh solver
                (``sweep.run_one``): incumbent, estimate, pools and
                iterations bit for bit the grid's (scripts/ci_checks.py's
                rerun rule).
     Phase 19 takes 3-4 minutes on an H100, most of it cold stormlike
     LPs (the set-up's mean-value LP, the steady rate's first calls from
     a fresh state, the evaluator's mean observation), and leaves the
     whole script 130-180 s inside its 1200 s; PERF.md section 5 says
     what could go if that margin shrinks.

Every SD phase sets the argmax kernel's launch count to 0 just before it
drives the path and requires, just after, as many launches as cuts formed
(none on the random-cost phases); phases 3-14 and 19's stops then time the
kernel on the height table of their final state (the n_sel its pools
reached) and hold it there against the plain version.  Peak device memory
is reported per phase.

Then a line with the card as nvidia-smi gives it, a ``kernels`` JSON line,
and last ``{"ok": true, "device": {...}}``.
"""

import contextlib
import glob
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Extensive-form optima of the finite-support instances (RESULTS.md §1).
OPTIMA = {"lands": 382.0222, "pgp2like": 113.3000}
GAP_LIMIT = 0.01
STORM_ITERS = 6                  # phase 5; see the docstring
STORM_B8_STEPS = 6
EVAL_LIMIT = 0.01                # UB against the exact objective
STORM_EVAL_LANES = 512
# Random-C instance (the JAX package's tests/test_e2e.py:52).
RANDC = dict(seed=2, n_rv=2, support=2, rand_C=2, n2=6, m2=4)
INSTANCES = ("lands", "pgp2like", "feastest", "intcaplike")
# The default configuration's pool capacities (MAX_ITER=5000: O=5120,
# L=S=7501, and the basis pool B=7501) for runs cut to fewer iterations.
DEFAULT_CAPS = dict(MAX_OMEGA=5001, MAX_LAMBDA=7501, MAX_SIGMA=7501,
                    MAX_BASES=7501)
FEAS_ITERS = 300
CKPT_EVERY = 100                 # lands: checkpoint cadence (samples)
COMPROMISE_VIOLATION = 1e-6      # rows and bounds at the compromise
CLI_REPS = 3
MESH_EVAL_LANES = 192            # 64 lanes per rank
MESH_TIMEOUT = 600               # seconds for the three ranks' run
OBS_TIMEOUT = 600                # seconds for phase 17's two ranks
# Almost every draw a new observation (4^7 scenarios), so that the pools of
# a SPREAD_ITERS-sample run fill both obs blocks of a 1x2 mesh.
SPREAD = dict(seed=4, n_rv=5, support=4, rand_C=2)
SPREAD_ITERS = 300
# Samples before the first stop test of spread_b16_obs2: ~3180 distinct
# observations expected under SPREAD's probabilities, past 2560.
SPREAD_B16_MIN = 3600
BAA_ITERS = 300
LP_ITERS = 150
LP_UB_LIMIT = 0.02               # LP-master UB against the optimum
MIQP_LIMIT = 0.01                # MIQP incumbent against the integer optimum
STOCH_CHECK_OBS = 32
# Partial pricing (phase 18): stormlike's second-stage LPs at these lane
# counts, warm from the mean observation's basis, drawn from PP_SEED.
PP_LANES = (8, 512)
PP_SEED = 11
PP_OBJ_RTOL = 1e-9
# Phase 19: the suite's largest families to the certified stop through
# suite_to_stop.run (pools derived from SUITE_MAX_ITER, the script's
# default), each incumbent evaluated on SUITE_EVAL_OBS observations; then
# the sweep grid on two small families with the exact gap, and one of its
# rows twice in fresh solvers.
SUITE_STOPS = (("stormlike", 64), ("ssnlike", 64))
SUITE_TOL = "l"
SUITE_CHECK_EVERY = 4
SUITE_MAX_ITER = 4096
SUITE_EVAL_OBS = 512
GRID_MAX_ITER = 1500             # the sweep's default
GRID = ["-p", "cep1like,baa99like", "-t", "n", "-s", "1,16", "-e", "0",
        "--parity", "100000", "--max-iter", str(GRID_MAX_ITER)]
GRID_ROWS = 4
RERUN = ("cep1like", "n", 16)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
# The last four: the full table and one rank's columns of it over 2 and 4
# obs ranks, and a shard width that splits oddly (8-byte cp.async rows).
SHARD_SHAPES = [(7501, 2560), (7501, 1280), (7501, 2561)]
ARGMAX_SHAPES = [(37, 128), (300, 256), (3000, 1024), (1001, 777),
                 *SHARD_SHAPES, (7501, 5120)]
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


@contextlib.contextmanager
def swapped(obj, attr, value):
    """``obj.attr`` is ``value`` inside the block (instrumentation of an
    entry point's internals); restored after it."""
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def timed(fn, seconds):
    """``fn`` appending each call's seconds (card synchronised) to
    ``seconds``."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.monotonic() - t)
        return out

    return call


def recording_qp(stats):
    """``ops/qp.solve_qp`` as the compromise module calls it, recording each
    solve's IPM iterations, seconds (card synchronised), size and
    certification in ``stats``."""
    from stochasticdecomposition_torch.core import compromise

    solve_qp = compromise.solve_qp

    def solve(Q, c, A, b, G, h, **kw):
        torch.cuda.synchronize()
        t = time.monotonic()
        res = solve_qp(Q, c, A, b, G, h, **kw)
        converged = bool(res.converged)
        stats.append({"ipm_iters": int(res.iters),
                      "seconds": time.monotonic() - t,
                      "converged": converged, "variables": Q.shape[0],
                      "eq_rows": A.shape[0], "ineq_rows": G.shape[0]})
        return res

    return swapped(compromise, "solve_qp", solve)


def first_stage_violation(pa, x) -> float:
    """The largest violation at x of A1 x {<=,=,>=} b1 and of l1 <= x <= u1."""
    A, b, sense, lo, hi = (t.cpu().numpy() for t in
                           (pa.A1, pa.b1, pa.sense1, pa.l1, pa.u1))
    r = A @ x - b
    rows = np.where(sense == 0, np.abs(r), np.where(sense > 0, -r, r))
    return float(max(np.max(rows, initial=0.0), np.max(lo - x),
                     np.max(x - hi), 0.0))


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
    full = argmax_cases.random_masks(rng, S)
    # (name, columns, masks): the full table, its pool prefixes, and one
    # obs rank's columns of it under the same masks.
    timed = [("full", O, full)]
    timed += [(f"prefix{n}", O, list(argmax_cases.prefix_masks(S, n)))
              for n in PREFIXES]
    timed += [(f"shard{w}", w, full) for _, w in SHARD_SHAPES]
    out = {"cases": checked, "shape": [S, O], "max_abs_err": max_err,
           "plan": argmax.split_plan(S, O)._asdict(), "timed": {}}
    for name, cols, np_masks in timed:
        Hc = H if cols == O else H[:, :cols].contiguous()
        b_ms, nbytes, n_sel = bound_ms(np_masks, cols)
        masks = [torch.as_tensor(m, device=dev) for m in np_masks]
        ms = cuda_ms(lambda: argmax.triple_masked_argmax(Hc, *masks),
                     TIMED_REPS, flush)
        row = {"n_sel": n_sel, "ms": ms, "bound_ms": b_ms, "bytes": nbytes,
               "GBps": nbytes / (ms * 1e-3) / 1e9,
               "bound_share": b_ms / ms}
        if not name.startswith("prefix"):
            row["plain_ms"] = cuda_ms(
                lambda: argmax.triple_masked_argmax_plain(Hc, *masks),
                TIMED_REPS, flush)
        if name == "full":
            row["profiler_ms"] = profiler_ms(
                lambda: argmax.triple_masked_argmax(H, *masks), 10, flush)
        out["timed"][name] = row
    return out


class Recorder:
    """``metrics`` for ``SDSolver.solve_replication``: keeps the last state
    and, if asked, each step's per-lane pivots."""

    def __init__(self, lanes: bool = False):
        self.last = None
        self.lanes = [] if lanes else None
        self.times = [time.monotonic()]

    def record(self, state):
        self.last = state
        if self.lanes is not None and state.lane_iters is not None:
            self.lanes.append(state.lane_iters.cpu().numpy())
            self.times.append(time.monotonic())


def load_problem(name):
    from stochasticdecomposition_torch.models.instances import load_instance
    from stochasticdecomposition_torch.models.suite import load_suite_instance
    from stochasticdecomposition_torch.models.synthetic import parse_synthetic
    from stochasticdecomposition_torch.prob import attach_stoc, decompose

    if name in ("randc", "spread"):
        core, tim, stoc = parse_synthetic(**(RANDC if name == "randc"
                                             else SPREAD))
    else:
        load = load_instance if name in INSTANCES else load_suite_instance
        core, tim, stoc = load(name)
    return attach_stoc(decompose(core, tim, stoc), stoc)


def run_sd(name, dev, cfg, lanes=False, via_run=False, bnb=False, **kw):
    """Replications through SDSolver, the user's entry point: ``run`` (all
    MULTIPLE_REP replications, their evaluations and the compromise) when
    ``via_run``, else ``solve_replication(0, **kw)``; returns (solver, the
    first replication's result, kernel launches during the run, recorder,
    with the RunResult in ``rec.run``).  The kernel is launched once per cut
    formed, except on random-cost problems, whose cut takes the random-cost
    argmax.  ``bnb`` counts the branch-and-bound master's nodes and waves
    in ``rec.bnb``."""
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.runner import RunResult, SDSolver

    solver = SDSolver(load_problem(name), cfg, device=dev)
    rec = Recorder(lanes)
    if bnb:
        mip = solver.mip_master
        rec.bnb = {"calls": 0, "nodes": 0, "waves": 0}

        def counted(state):
            r = mip(state)
            rec.bnb["calls"] += 1
            rec.bnb["nodes"] += r.nodes
            rec.bnb["waves"] += r.waves
            return r

        solver.mip_master = counted
    argmax.launches = 0
    t = time.monotonic()
    if via_run:
        rec.run = solver.run(metrics=rec)
    else:
        rec.run = RunResult(solver.sp.name,
                            [solver.solve_replication(0, metrics=rec, **kw)])
    torch.cuda.synchronize()
    reps = rec.run.replications
    rec.eval_seconds = time.monotonic() - t - sum(r.time_total for r in reps)
    launches = argmax.launches
    cuts = sum(r.cuts_formed for r in reps)
    expected = 0 if solver.pa.rv_d_cols.shape[0] else cuts
    if launches != expected:
        fail(f"{name}: {launches} kernel launches for {cuts} cuts formed")
    return solver, reps[0], launches, rec


def kernel_at_stop(solver, state, flush):
    """The argmax kernel on the height table of the final state: its time,
    the plain version's, the n_sel bound, and exact agreement."""
    import math

    from stochasticdecomposition_torch.core.cuts import height_table
    from stochasticdecomposition_torch.ops import argmax

    H, s_valid, _ = height_table(solver.pa, state, state.candid_x)
    k = state.k
    ns_eff = k - math.floor(0.1 * float(k) + 1)
    masks = [s_valid, s_valid & (state.sigma_ck <= ns_eff),
             s_valid & (state.sigma_ck > ns_eff)]
    before = argmax.launches
    got = argmax.triple_masked_argmax(H, *masks)
    want = argmax.triple_masked_argmax_plain(H, *masks)
    torch.cuda.synchronize()
    if not all(same(g, w) for g, w in zip(got, want)):
        fail("argmax kernel differs from its plain version at the stop")
    ms = cuda_ms(lambda: argmax.triple_masked_argmax(H, *masks),
                 TIMED_REPS, flush)
    plain = cuda_ms(lambda: argmax.triple_masked_argmax_plain(H, *masks),
                    5, flush)
    argmax.launches = before
    b_ms, nbytes, n_sel = bound_ms([m.cpu().numpy() for m in masks],
                                   H.shape[1])
    return {"shape": list(H.shape), "n_sel": n_sel, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bytes": nbytes}


def resume_check(solver, whole, ckdir):
    """Resume from the last checkpoint of ``whole``'s run: the resumed
    replication must return ``whole``'s iterations, incumbent (bit-equal),
    estimate, pools and cuts; it launches the kernel once per cut formed
    after the checkpoint.  Returns (JSON fields, launches)."""
    from stochasticdecomposition_torch.core.state import init_state
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.utils.checkpoint import load_state

    ckpts = sorted(glob.glob(os.path.join(ckdir, "rep00_k*.npz")))
    if not ckpts:
        fail("lands: no checkpoint was written")
    path = ckpts[-1]
    at = load_state(path, init_state(solver.pa, solver.caps, solver.cfg,
                                     solver.mean_sol))
    k_at, cuts_at = at.k, at.cut_cnt
    del at
    argmax.launches = 0
    t = time.monotonic()
    res = solver.solve_replication(0, resume_from=path)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t
    launches = argmax.launches
    same = (res.iterations == whole.iterations and res.optimal == whole.optimal
            and np.array_equal(res.incumb_x, whole.incumb_x)
            and res.incumb_est == whole.incumb_est
            and res.pool_sizes == whole.pool_sizes
            and res.cuts_formed == whole.cuts_formed)
    out = {"checkpoints": len(ckpts), "resumed_from_k": k_at,
           "resume_identical": same, "resumed_seconds": seconds,
           "resumed_iterations": res.iterations - k_at,
           "resume_launches": launches}
    if not same:
        fail(f"lands: the resumed replication differs ({out}; "
             f"{res} != {whole})")
    if launches != whole.cuts_formed - cuts_at:
        fail(f"lands: {launches} kernel launches after the resume for "
             f"{whole.cuts_formed - cuts_at} cuts formed")
    return out, launches


def exact_check(solver, name, x):
    """(exact objective at x, the optimum, exact gap) by enumeration of the
    finite support."""
    from stochasticdecomposition_torch.models.extensive import (
        enumerate_scenarios, exact_objective_fn, solve_extensive_form,
    )

    outs, probs = enumerate_scenarios(solver.sp._stoc, solver.sp.rv_order)
    exact = exact_objective_fn(solver.pa, outs, probs)(x)
    opt = OPTIMA[name] if name in OPTIMA else \
        solve_extensive_form(solver.sp, outs, probs)[0]
    return exact, opt, abs(exact - opt) / abs(opt)


def run_fields(name, dev, cfg, via_run=False, bnb=False, exact=True, **kw):
    """A replication and the JSON fields every SD phase reports, with the
    incumbent's exact objective and gap when ``exact`` (finite support);
    returns (fields, solver, result, recorder)."""
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    solver, res, launches, rec = run_sd(name, dev, cfg, via_run=via_run,
                                        bnb=bnb, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    batch = cfg.SAMPLE_INCREMENT
    out = {"sample_increment": batch, "stop_iteration": res.iterations,
           "steps": res.iterations // batch, "certified": res.optimal,
           "sd_seconds": res.time_total,
           "seconds_per_iteration": res.time_total / max(res.iterations, 1),
           "launches": launches,
           "cuts_formed": sum(r.cuts_formed for r in rec.run.replications),
           "lps": res.lp_count,
           "incumb_est": res.incumb_est, "incumb_x": res.incumb_x.tolist(),
           "pools": res.pool_sizes,
           "caps": solver.caps._asdict(), "full_tests": res.full_tests,
           "feas_rounds": res.feas_rounds,
           "master_failures": res.master_failures,
           "pivots_per_lp": res.lp_pivots / max(res.lp_count, 1),
           "ipm_iters_per_master": res.qp_iters / max(res.iterations //
                                                      batch, 1),
           "peak_allocated_bytes": peak,
           # The run's own peak: without the flush buffer and what earlier
           # phases still hold.
           "peak_above_start_bytes": peak - start}
    if exact:
        out["exact_objective"], out["optimum"], out["exact_gap"] = \
            exact_check(solver, name, res.incumb_x)
    return out, solver, res, rec


def check_gap(name, out):
    if out["exact_gap"] > GAP_LIMIT:
        fail(f"{name}: exact gap {out['exact_gap']} exceeds {GAP_LIMIT} "
             f"({out})")


def phase_to_stop(name, dev, cfg, flush, via_run=False, **kw):
    """SD to the certified stop; returns (JSON fields, solver, result)."""
    out, solver, res, rec = run_fields(name, dev, cfg, via_run=via_run, **kw)
    check_gap(name, out)
    if not res.optimal:
        fail(f"{name}: no certified stop before MAX_ITER ({out})")
    if out["launches"] <= 0:
        fail(f"{name}: the argmax kernel was never launched")
    if rec.last is not None:
        out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    return out, solver, res, rec


def phase_feastest(dev, flush):
    """Feasibility mode for FEAS_ITERS iterations at the default
    capacities."""
    from stochasticdecomposition_torch.config import SDConfig

    cfg = SDConfig(EVAL_FLAG=False, MAX_ITER=FEAS_ITERS, **DEFAULT_CAPS)
    from stochasticdecomposition_torch.core.stopping import (
        bootstrap_bounds, bootstrap_draws,
    )
    from stochasticdecomposition_torch.runner import replication_generators

    out, solver, res, rec = run_fields("feastest", dev, cfg)
    check_gap("feastest", out)
    x = res.incumb_x
    out["induced_lhs"] = float(x[0] + x[1])
    # Why no certified stop: the full test's two sides on the final state
    # (median over the resamples) and the proximal term they divide by.
    st = rec.last
    draws = bootstrap_draws(st, replication_generators(0, dev)[1],
                            cfg.BOOTSTRAP_REP)
    bounds = bootstrap_bounds(solver.pa, cfg, st, draws)
    out["final_full_test"] = None if bounds is None else {
        "est_median": float(torch.median(bounds[0])),
        "lb_median": float(torch.median(bounds[1])),
        "quad_scalar": float(st.quad_scalar),
        "incumb_chg": st.incumb_chg}
    if res.feas_rounds <= 0:
        fail(f"feastest: feasibility mode never ran ({out})")
    if x[0] + x[1] < 6.0 - 1e-6:
        fail(f"feastest: incumbent {x} violates x1 + x2 >= 6")
    if res.iterations != FEAS_ITERS or out["launches"] <= 0:
        fail(f"feastest: {out}")
    out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    return out


def randcost_argmax_check(solver, state, flush):
    """The blockwise random-cost argmax on the final state against the
    materialized [B, O] table: heights exactly, indices up to equal heights;
    the time of each (CUDA events, median), the basis rows it scans."""
    import math

    from stochasticdecomposition_torch.core.randcost import (
        height_table_randcost, triple_argmax_randcost,
    )

    pa, x, k = solver.pa, state.candid_x, state.k
    ns_eff = k - math.floor(0.1 * float(k) + 1)
    og, ng = state.basis_ck <= ns_eff, state.basis_ck > ns_eff

    def blockwise():
        return triple_argmax_randcost(pa, state, x, og, ng)

    def materialized():
        H, valid, _ = height_table_randcost(pa, state, x)
        out = []
        for gate in (None, og, ng):
            m = valid if gate is None else valid & gate[:, None]
            Hm = torch.where(m, H, -1e300)
            out += [torch.argmax(Hm, dim=0), torch.amax(Hm, dim=0)]
        return out, H

    got = blockwise()
    want, H = materialized()
    torch.cuda.synchronize()
    cols = torch.arange(H.shape[1], device=H.device)
    for j in range(3):
        i_got, h_got, h_want = got[2 * j], got[2 * j + 1], want[2 * j + 1]
        if not torch.equal(h_got, h_want):
            fail(f"random-cost argmax: heights differ from the materialized "
                 f"table (mask {j})")
        live = h_want > -1e299
        if not torch.equal(H[i_got, cols][live], h_want[live]):
            fail(f"random-cost argmax: an index off the max (mask {j})")
    # Indices that differ from the materialized argmax, each at a height
    # equal to the max (shown above).
    ties = int(sum(torch.sum(got[2 * j] != want[2 * j]) for j in range(3)))
    del H, want
    # The bytes the function must move: the delta_pib rows of the lambda
    # entries the live bases reference, their obs_feas rows, six [O]
    # outputs.
    live = min(state.basis_cnt, state.basis_sigma0.shape[0])
    sig = torch.cat([state.basis_sigma0[:live, None],
                     state.basis_sigma_idx[:live]], dim=1)
    rows = int(torch.unique(state.sigma_lidx[sig]).shape[0])
    O = state.omega_vals.shape[0]
    nbytes = rows * O * 8 + live * O + 48 * O
    return {"basis_rows": live, "lambda_rows": rows, "index_ties": ties,
            "ms": cuda_ms(blockwise, 10, flush),
            "materialized_ms": cuda_ms(lambda: materialized()[0], 3, flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


def phase_randcost(name, dev, cfg, flush, exact):
    """A random-cost replication at the default capacities."""
    out, solver, res, rec = run_fields(name, dev, cfg, exact=exact)
    if exact:
        check_gap(name, out)
    st = rec.last
    out["basis_cnt"] = st.basis_cnt
    out["pool_bytes"] = solver.pool_bytes["total"]
    if out["launches"] != 0:
        fail(f"{name}: the plain argmax kernel ran on a random-cost cut")
    out["randcost_argmax"] = randcost_argmax_check(solver, st, flush)
    return out, solver, res, rec


def stoch_check(solver, state, n_obs):
    """STOCH_CHECK: at the final candidate, the best valid random-cost
    height of each of the first ``n_obs`` stored observations is at most
    the subproblem's optimal value + 1e-6 (weak duality); returns the
    largest excess and how many are exact to 1e-7."""
    from stochasticdecomposition_torch.core.randcost import (
        height_table_randcost,
    )
    from stochasticdecomposition_torch.core.update import (
        subproblem_rhs_cost_lanes,
    )
    from stochasticdecomposition_torch.ops.simplex import (
        STATUS_OPTIMAL, solve_lp,
    )

    pa, x = solver.pa, state.candid_x
    n = min(n_obs, state.omega_cnt)
    H, valid, _ = height_table_randcost(pa, state, x)
    hstar = torch.amax(torch.where(valid, H, -1e300), dim=0)[:n]
    del H, valid
    rhs, cost = subproblem_rhs_cost_lanes(pa, x, state.omega_vals[:n])
    res = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs)
    if not bool(torch.all(res.status == STATUS_OPTIMAL)):
        fail("STOCH_CHECK: a subproblem was not solved to optimality")
    excess = hstar - res.obj
    worst = float(torch.amax(excess))
    if worst > 1e-6:
        fail(f"STOCH_CHECK: a random-cost height exceeds the subproblem's "
             f"optimal value by {worst}")
    return {"observations": n, "max_excess": worst,
            "exact": int(torch.sum(torch.abs(excess) < 1e-7))}


def phase_lands_lp(dev, flush):
    """The LP master for LP_ITERS iterations, then the evaluation."""
    from stochasticdecomposition_torch.config import MASTER_LP, SDConfig

    cfg = SDConfig(EVAL_FLAG=True, MASTER_TYPE=MASTER_LP, MAX_ITER=LP_ITERS,
                   **DEFAULT_CAPS)
    out, solver, res, rec = run_fields("lands", dev, cfg, via_run=True)
    ev = res.eval
    out["eval"] = eval_fields(solver, ev, rec.eval_seconds)
    out["ub_vs_optimum"] = (ev.mean - out["optimum"]) / abs(out["optimum"])
    if res.optimal or res.iterations != LP_ITERS:
        fail(f"lands_lp: the LP master stopped early ({out})")
    if not -0.01 < out["ub_vs_optimum"] < LP_UB_LIMIT:
        fail(f"lands_lp: UB {ev.mean} off the optimum ({out})")
    if out["launches"] <= 0:
        fail("lands_lp: the argmax kernel was never launched")
    out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    return out


def integer_optimum(solver):
    """The integer first stage of least exact cost, by enumerating every
    integer point of the first-stage box that meets the first-stage rows."""
    import itertools

    from stochasticdecomposition_torch.models.extensive import (
        enumerate_scenarios, exact_objective_fn,
    )

    pa = solver.pa
    outs, probs = enumerate_scenarios(solver.sp._stoc, solver.sp.rv_order)
    cost = exact_objective_fn(pa, outs, probs)
    lo, hi = pa.l1.cpu().numpy(), pa.u1.cpu().numpy()
    A, b, sense = (t.cpu().numpy() for t in (pa.A1, pa.b1, pa.sense1))
    best = (np.inf, None)
    for x in itertools.product(*(range(int(np.ceil(a)), int(np.floor(c)) + 1)
                                 for a, c in zip(lo, hi))):
        lhs = A @ np.asarray(x, float)
        if np.any((sense > 0) & (lhs < b - 1e-9)) or \
                np.any((sense < 0) & (lhs > b + 1e-9)) or \
                np.any((sense == 0) & (np.abs(lhs - b) > 1e-9)):
            continue
        best = min(best, (cost(np.asarray(x, float)), x))
    return best, cost


def phase_intcap_miqp(dev, flush):
    """The MIQP master with the branch-and-bound on intcaplike, two
    replications and the integer compromise through ``SDSolver.run``."""
    from stochasticdecomposition_torch.config import MASTER_MIQP, SDConfig

    cfg = SDConfig(EVAL_FLAG=False, MASTER_TYPE=MASTER_MIQP, MAX_ITER=120,
                   MIN_ITER=40, MULTIPLE_REP=2, COMPROMISE_PROB=True,
                   **DEFAULT_CAPS)
    qp = []
    with recording_qp(qp):
        out, solver, res, rec = run_fields("intcaplike", dev, cfg, bnb=True,
                                           exact=False, via_run=True)
    (opt, x_opt), cost = integer_optimum(solver)
    run = rec.run
    iterations = sum(r.iterations for r in run.replications)
    out.update(integer_optimum=opt, integer_optimum_x=list(x_opt),
               bnb=rec.bnb,
               bnb_nodes_per_iteration=rec.bnb["nodes"] / iterations,
               bnb_waves_per_iteration=rec.bnb["waves"] / iterations)
    points = [(f"replication {r.rep}", r.incumb_x) for r in run.replications]
    points.append(("compromise", run.compromise_x))
    out["replications"] = [{"iterations": r.iterations,
                            "sd_seconds": r.time_total,
                            "cuts_formed": r.cuts_formed,
                            "incumb_x": r.incumb_x.tolist()}
                           for r in run.replications]
    out["integer_gaps"] = {}
    for what, x in points:
        got = cost(np.round(x))
        out["integer_gaps"][what] = (got - opt) / abs(opt)
        if not np.allclose(x, np.round(x), atol=1e-6):
            fail(f"intcaplike_miqp: {what} {x} is not integral")
        if out["integer_gaps"][what] > MIQP_LIMIT:
            fail(f"intcaplike_miqp: {what} cost {got} is off the integer "
                 f"optimum {opt} ({out})")
    out["compromise_x"] = run.compromise_x.tolist()
    out["compromise_nodes"] = len(qp)
    out["compromise_seconds"] = sum(q["seconds"] for q in qp)
    out["compromise_ipm_iters"] = [q["ipm_iters"] for q in qp]
    if out["launches"] <= 0 or rec.bnb["calls"] != iterations:
        fail(f"intcaplike_miqp: {out}")
    out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    return out


def phase_cli(dev):
    """The CLI in process: pgp2like, CLI_REPS replications to the certified
    stop with the evaluation, the compromise and the average decisions, the
    metrics stream and phase times, at the default capacities.  The
    kernel is launched once per cut formed, plus (1 + SAMPLES) times per
    replication by the phase-time estimate's ``cut_step`` calls."""
    from stochasticdecomposition_torch import cli, runner
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.utils.metrics import SAMPLES

    seen = {}
    run = runner.SDSolver.run

    def kept_run(self, *a, **kw):
        seen["solver"] = self
        seen["run"] = run(self, *a, **kw)
        return seen["run"]

    estimate = runner.estimate_phase_times
    phase_launches = []

    def counted_estimate(*a, **kw):
        before = argmax.launches
        times = estimate(*a, **kw)
        phase_launches.append(argmax.launches - before)
        return times

    qp = []
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            swapped(runner.SDSolver, "run", kept_run), \
            swapped(runner, "estimate_phase_times", counted_estimate), \
            recording_qp(qp), contextlib.redirect_stdout(text):
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        argmax.launches = 0
        t = time.monotonic()
        rc = cli.main(["-p", "pgp2like", "-m", str(CLI_REPS), "-c", "1",
                       "-e", "1", "-o", tmp, "--metrics-every", "10",
                       "--time-phases"])
        torch.cuda.synchronize()
        seconds = time.monotonic() - t
        launches = argmax.launches
        peak = torch.cuda.max_memory_allocated(dev)
        out_dir = os.path.join(tmp, "twoSD_torch", "pgp2like")
        files = sorted(os.listdir(out_dir))
        rows = open(os.path.join(out_dir, "detailedResults.csv")).read() \
            .splitlines()[1:]
        summary = open(os.path.join(out_dir, "summary.dat")).read()
        metric_lines = [sum(1 for _ in open(os.path.join(
            out_dir, f"metrics_rep{r:02d}.jsonl"))) for r in range(CLI_REPS)]
    solver, result = seen["solver"], seen["run"]
    reps = result.replications
    out = {"rc": rc, "cli_seconds": seconds, "files": files,
           "launches": launches,
           "cuts_formed": sum(r.cuts_formed for r in reps),
           "phase_time_launches": sum(phase_launches),
           "peak_allocated_bytes": peak,
           "peak_above_start_bytes": peak - start,
           "metrics_lines": metric_lines, "replications": []}
    for r in reps:
        exact, _, gap = exact_check(solver, "pgp2like", r.incumb_x)
        out["replications"].append({
            "iterations": r.iterations, "certified": r.optimal,
            "sd_seconds": r.time_total, "exact_gap": gap,
            "ub": r.eval.mean, "ub_vs_exact": abs(r.eval.mean - exact) /
            abs(exact), "launches_for_cuts": r.cuts_formed,
            "phase_times": [r.time_master, r.time_subprob, r.time_opttest,
                            r.time_argmax]})
        if not r.optimal or gap > GAP_LIMIT:
            fail(f"cli_pgp2like_m3: replication {r.rep} "
                 f"{out['replications'][-1]}")
    for what, x, ev in (("compromise", result.compromise_x,
                         result.compromise_eval),
                        ("average", result.average_x, result.average_eval)):
        exact, _, gap = exact_check(solver, "pgp2like", x)
        out[what] = {"x": x.tolist(), "exact_objective": exact,
                     "exact_gap": gap, "ub": ev.mean,
                     "ub_vs_exact": abs(ev.mean - exact) / abs(exact)}
        if out[what]["ub_vs_exact"] > EVAL_LIMIT:
            fail(f"cli_pgp2like_m3: the {what}'s UB is off its exact "
                 f"objective ({out[what]})")
    out["compromise"].update(qp[0] if len(qp) == 1 else {"solves": qp})
    if rc != 0 or len(reps) != CLI_REPS or len(qp) != 1 or \
            out["compromise"]["exact_gap"] > GAP_LIMIT:
        fail(f"cli_pgp2like_m3: {out}")
    if {"detailedResults.csv", "incumb.dat", "results.jsonl",
            "summary.dat"} - set(files) or len(rows) != CLI_REPS or \
            any(float(v) < 0 for row in rows
                for v in row.split("\t")[4:8]) or \
            "Compromise solution" not in summary or \
            "Average solution" not in summary or min(metric_lines) <= 0:
        fail(f"cli_pgp2like_m3: result files ({out}, {rows})")
    if sum(phase_launches) != CLI_REPS * (1 + SAMPLES) or \
            launches != out["cuts_formed"] + sum(phase_launches):
        fail(f"cli_pgp2like_m3: {launches} kernel launches for "
             f"{out['cuts_formed']} cuts formed and {sum(phase_launches)} "
             "phase-time cuts")
    if "Starting two-stage stochastic decomposition (PyTorch)." not in \
            text.getvalue():
        fail("cli_pgp2like_m3: the CLI did not start")
    return out, result


def mesh_rank(root):
    """One rank of phase 16 (started by torchrun): the CLI over the 3x1
    mesh, then the sharded evaluation beside ``make_eval_batch``; writes
    ``root/rankR.json``."""
    from stochasticdecomposition_torch import cli, runner
    from stochasticdecomposition_torch.core.evaluate import (
        eval_generator, make_eval_batch,
    )
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.parallel.mesh import (
        make_mesh, make_sharded_eval,
    )

    seen = {}
    run = runner.SDSolver.run

    def kept_run(self, *a, **kw):
        seen["solver"] = self
        seen["run"] = run(self, *a, **kw)
        return seen["run"]

    rank = int(os.environ["RANK"])
    with swapped(runner.SDSolver, "run", kept_run):
        argmax.launches = 0
        t = time.monotonic()
        rc = cli.main(["-p", "pgp2like", "-m", str(CLI_REPS), "-c", "1",
                       "-e", "1", "--mesh", f"{CLI_REPS}x1",
                       "--distributed", "-o",
                       os.path.join(root, f"rank{rank}")])
        torch.cuda.synchronize()
        seconds = time.monotonic() - t
        launches = argmax.launches
    solver, result = seen["solver"], seen["run"]
    dev = solver.device
    mesh = make_mesh(CLI_REPS, 1)
    mine = [r for r in result.replications if mesh.lead_rank(r.rep) == rank]
    out = {"rank": rank, "rc": rc,
           "device": str(dev), "card": torch.cuda.get_device_name(dev),
           "cli_seconds": seconds, "launches": launches,
           "cuts_formed": sum(r.cuts_formed for r in mine),
           "ran": [r.rep for r in mine],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "replications": [{
               "rep": r.rep, "iterations": r.iterations,
               "optimal": r.optimal, "unique_omegas": r.unique_omegas,
               "pool_sizes": r.pool_sizes, "incumb_x": r.incumb_x.tolist(),
               "incumb_est": r.incumb_est,
               "ub": None if r.eval is None else r.eval.mean}
               for r in result.replications]}
    if result.compromise_x is not None:
        out["compromise_x"] = result.compromise_x.tolist()
        out["average_x"] = result.average_x.tolist()
        out["compromise_ub"] = result.compromise_eval.mean
        out["average_ub"] = result.average_eval.mean
    x = result.replications[0].incumb_x
    seed = solver.cfg.EVAL_SEED[0]
    sharded = make_sharded_eval(solver.pa, solver.spec, MESH_EVAL_LANES,
                                mesh)
    t = time.monotonic()
    got = sharded(x, eval_generator(seed, dev))
    out["sharded_eval_seconds"] = time.monotonic() - t
    want = make_eval_batch(solver.pa, solver.spec, MESH_EVAL_LANES)(
        x, eval_generator(seed, dev))
    out["sharded_eval"] = {"sharded": list(got), "single": list(want)}
    with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def torchrun(phase, flag, root, nproc, timeout):
    """``chip_smoke.py <flag> root`` as ``nproc`` ranks under
    ``python -m torch.distributed.run --standalone``, killed with its ranks
    at ``timeout`` seconds; fails the phase unless every rank ends well.
    Returns (the ranks' log, seconds, each rank's ``root/rankR.json``)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__), flag,
           root]
    log_path = os.path.join(root, "torchrun.log")
    t = time.monotonic()
    with open(log_path, "w") as log:
        # Its own session, so that a timeout kills the ranks too.
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    seconds = time.monotonic() - t
    text = open(log_path).read()
    if rc != 0:
        fail(f"{phase}: torchrun exited {rc}:\n{text[-6000:]}")
    return text, seconds, [
        json.load(open(os.path.join(root, f"rank{r}.json")))
        for r in range(nproc)]


def obs_bytes(state) -> int:
    """The bytes of the state's observation-axis fields (the five of
    ``core/state.OBS_AXIS`` and, with random costs, ``obs_feas``)."""
    from stochasticdecomposition_torch.core.state import obs_fields

    return sum(getattr(state, f).nbytes for f in obs_fields(state))


def rep_fields(r) -> dict:
    return {"rep": r.rep, "iterations": r.iterations, "optimal": r.optimal,
            "unique_omegas": r.unique_omegas, "pool_sizes": r.pool_sizes,
            "incumb_x": r.incumb_x.tolist(), "incumb_est": r.incumb_est,
            "cuts_formed": r.cuts_formed, "sd_seconds": r.time_total}


def baa_cfg():
    """baa99-20like's configuration (phases 12 and 17): BAA_ITERS
    iterations at the default capacities; nd = 4 cost RVs, so lambda and
    sigma hold 4 * 5000 + 2501 rows."""
    from stochasticdecomposition_torch.config import SDConfig

    return SDConfig(EVAL_FLAG=False, MAX_ITER=BAA_ITERS,
                    **{**DEFAULT_CAPS, "MAX_LAMBDA": 22501,
                       "MAX_SIGMA": 22501})


# Phase 17's random-cost runs, held to phases 11 and 12.
RANDCOST_OBS2 = ("fleetminilike_obs2", "baa99-20like_obs2")


def obs2_runs():
    """Phase 17's runs through ``SDSolver.run`` (pgp2like goes through the
    CLI): (phase, instance, config, checkpoint cadence or 0)."""
    from stochasticdecomposition_torch.config import SDConfig

    return [("lands_b16_obs2", "lands",
             SDConfig(EVAL_FLAG=False, SAMPLE_INCREMENT=16), 0),
            ("spread_obs2", "spread",
             SDConfig(EVAL_FLAG=False, MAX_ITER=SPREAD_ITERS), 0),
            ("spread_b16_obs2", "spread",
             SDConfig(EVAL_FLAG=False, SAMPLE_INCREMENT=16,
                      MIN_ITER=SPREAD_B16_MIN), CKPT_EVERY),
            ("fleetminilike_obs2", "fleetminilike",
             SDConfig(EVAL_FLAG=False), 0),
            ("baa99-20like_obs2", "baa99-20like", baa_cfg(), 0)]


def obs_rank(root):
    """One rank of phase 17 (started by torchrun): pgp2like through the CLI
    on a 1x2 mesh, then ``obs2_runs`` through ``SDSolver.run`` on a 1x2
    mesh; for each, this rank's launches, the bytes of its state's
    observation-axis fields, ``estimate_pool_bytes`` for the rank, its
    peak memory, its obs collectives' wall seconds and calls, and the
    results; with random costs the blockwise argmax against the
    materialized table on the rank's final state; with checkpoints this
    rank's seconds in ``save_state`` (obs rank 0 writes).  Then
    spread_b16_obs2 resumed over the 1x2 mesh from its last checkpoint
    (``<phase>_resume``).  Writes ``root/rankR.json``."""
    from stochasticdecomposition_torch import cli, runner
    from stochasticdecomposition_torch.core.state import estimate_pool_bytes
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.parallel import distributed
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    rank = int(os.environ["RANK"])
    last, saves = {}, []
    lockstep = runner.check_lockstep

    def kept_state(state):
        # Called with the final state at the end of every replication.
        lockstep(state)
        last["state"] = state
    held = []
    init = runner.init_state

    def recorded(*a, **kw):
        st = init(*a, **kw)
        held.append((obs_bytes(st), [st.shard.lo, st.shard.hi]))
        return st

    seen = {}
    run = runner.SDSolver.run

    def kept_run(self, *a, **kw):
        seen["solver"] = self
        seen["run"] = run(self, *a, **kw)
        return seen["run"]

    def measured(fn, k0=0):
        held.clear()
        saves.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        argmax.launches = 0
        distributed.obs_seconds, distributed.obs_calls = 0.0, 0
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        res = seen["run"].replications[0]
        sol = seen["solver"]
        steps = -(-(res.iterations - k0) // max(1, sol.cfg.SAMPLE_INCREMENT))
        return {"seconds": time.monotonic() - t, "launches": argmax.launches,
                "steps": steps, "obs_seconds": distributed.obs_seconds,
                "obs_calls": distributed.obs_calls,
                "obs_seconds_per_step": distributed.obs_seconds / steps,
                "obs_share_of_sd": distributed.obs_seconds / res.time_total,
                "obs_bytes": held[0][0], "shard": held[0][1],
                "estimated_pool_bytes": estimate_pool_bytes(
                    sol.sp, sol.caps, sol.cfg, 2)["total"],
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                **rep_fields(res)}

    out = {"rank": rank}
    flush = None
    with swapped(runner, "init_state", recorded), \
            swapped(runner.SDSolver, "run", kept_run), \
            swapped(runner, "check_lockstep", kept_state), \
            swapped(runner, "save_state", timed(runner.save_state, saves)):
        rc = []
        out["pgp2like_obs2"] = measured(lambda: rc.append(cli.main(
            ["-p", "pgp2like", "-e", "0", "--mesh", "1x2", "--distributed",
             "-o", os.path.join(root, f"rank{rank}")])))
        out["pgp2like_obs2"]["rc"] = rc[0]
        dev = seen["solver"].device
        for phase, name, cfg, every in obs2_runs():
            solver = runner.SDSolver(load_problem(name), cfg, device=dev)
            kw = {} if not every else dict(
                checkpoint_every=every,
                checkpoint_dir=os.path.join(root, "ckpt_" + phase))
            out[phase] = measured(lambda: solver.run(mesh=make_mesh(1, 2),
                                                     **kw))
            if every:
                out[phase]["checkpoint_seconds"] = list(saves)
            if phase in RANDCOST_OBS2:
                if flush is None:
                    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                        device=dev)
                out[phase]["randcost_argmax"] = randcost_argmax_check(
                    solver, last["state"], flush)
            del solver
        out.update(obs2_resume(root, rank, dev, measured))
    out["device"] = str(dev)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def obs2_resume(root, rank, dev, measured):
    """spread_b16_obs2 resumed over the 1x2 mesh from a copy of its last
    checkpoint (the lead rank copies it; every rank reads it); obs rank 0's
    checkpoint bytes."""
    import torch.distributed as dist

    from stochasticdecomposition_torch.parallel.mesh import make_mesh
    from stochasticdecomposition_torch.runner import SDSolver

    phase = "spread_b16_obs2"
    _, name, cfg, _ = next(r for r in obs2_runs() if r[0] == phase)
    files = sorted(glob.glob(os.path.join(root, "ckpt_" + phase,
                                          "mesh_wave00_rep00_k*.npz")))
    if not files:
        raise RuntimeError(f"{phase}: no checkpoint was written")
    src = files[-1]
    start = os.path.join(root, "resume_" + phase, os.path.basename(src))
    if rank == 0:
        os.makedirs(os.path.dirname(start))
        shutil.copy(src, start)
    dist.barrier()
    with np.load(src) as f:
        k_at, cuts_at = int(f["k"]), int(f["cut_cnt"])
    solver = SDSolver(load_problem(name), cfg, device=dev)
    row = measured(lambda: solver.run(mesh=make_mesh(1, 2),
                                      resume_from=start), k0=k_at)
    row.update(resumed_from=os.path.basename(src), k_at=k_at,
               cuts_at=cuts_at, checkpoint_path=src)
    out = {phase + "_resume": row}
    if rank == 0:
        out["checkpoint_bytes"] = [os.path.getsize(f) for f in files]
    return out


def resume_1x1(dev, cfg, src):
    """A copy of ``src``, a checkpoint of the 1x2 run, resumed on a 1x1 mesh
    in this process: (the replication, launches, seconds)."""
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.parallel.mesh import make_mesh
    from stochasticdecomposition_torch.runner import SDSolver

    solver = SDSolver(load_problem("spread"), cfg, device=dev)
    with tempfile.TemporaryDirectory() as d:
        start = os.path.join(d, os.path.basename(src))
        shutil.copy(src, start)
        argmax.launches = 0
        t = time.monotonic()
        res = solver.run(mesh=make_mesh(1, 1),
                         resume_from=start).replications[0]
        torch.cuda.synchronize()
    return res, argmax.launches, time.monotonic() - t


def phase_obs2(dev, pgp_solver, pgp_res, randcost_res):
    """Phase 17: one replication's pools split over two ranks that share
    the card (``--mesh 1x2``): pgp2like at the default capacities through
    the CLI, held to phase 4's replication ``pgp_res``; lands at
    SAMPLE_INCREMENT 16 and ``spread`` at batch 1 and 16 (whose
    observations fill both ranks' columns) through ``SDSolver.run``, held
    to the same runs unsharded, made here first; fleetminilike and
    baa99-20like (random costs), held to phases 11 and 12's replications
    ``randcost_res``; spread_b16_obs2 resumed from its last checkpoint over
    1x2 (bit-identical) and 1x1 (within 1e-8).  Returns {phase:
    fields}."""
    from stochasticdecomposition_torch.core.state import init_state
    from stochasticdecomposition_torch.ops import argmax
    from stochasticdecomposition_torch.runner import SDSolver

    want, ref = {"pgp2like_obs2": pgp_res}, {}
    st = init_state(pgp_solver.pa, pgp_solver.caps, pgp_solver.cfg,
                    pgp_solver.mean_sol)
    whole = {"pgp2like_obs2": obs_bytes(st)}
    del st
    for phase, name, cfg, _ in obs2_runs():
        solver = SDSolver(load_problem(name), cfg, device=dev)
        st = init_state(solver.pa, solver.caps, cfg, solver.mean_sol)
        whole[phase] = obs_bytes(st)
        del st
        if phase in randcost_res:
            want[phase] = randcost_res[phase]
            ref[phase] = {"launches": 0, **rep_fields(want[phase])}
            continue
        argmax.launches = 0
        res = solver.run().replications[0]
        torch.cuda.synchronize()
        if argmax.launches != res.cuts_formed:
            fail(f"{phase}: {argmax.launches} launches for "
                 f"{res.cuts_formed} cuts in the unsharded run")
        want[phase] = res
        ref[phase] = {"launches": argmax.launches, **rep_fields(res)}

    with tempfile.TemporaryDirectory() as root:
        text, seconds, ranks = torchrun("obs2", "--obs-rank", root, 2,
                                        OBS_TIMEOUT)
        files = sorted(os.listdir(os.path.join(
            root, "rank0", "twoSD_torch", "pgp2like")))
        rank1_files = os.path.exists(os.path.join(root, "rank1"))
        resumed = ranks[0]["spread_b16_obs2_resume"]
        cfg_b16 = next(r[2] for r in obs2_runs()
                       if r[0] == "spread_b16_obs2")
        one, one_launches, one_s = resume_1x1(dev, cfg_b16,
                                              resumed["checkpoint_path"])
    card = torch.cuda.get_device_name(dev)
    out = {}
    for phase, w in want.items():
        rows = [rk[phase] for rk in ranks]
        problems = []
        for r, g in enumerate(rows):
            if (g["iterations"], g["optimal"], g["unique_omegas"],
                    g["pool_sizes"]) != (w.iterations, w.optimal,
                                         w.unique_omegas, w.pool_sizes) or \
                    not within(g["incumb_x"], w.incumb_x, 1e-8) or \
                    not within(g["incumb_est"], w.incumb_est, 1e-8):
                problems.append(f"rank {r}: the replication differs from "
                                f"the unsharded run ({g} vs {w})")
            if (g["launches"] != 0 if phase in RANDCOST_OBS2 else
                    g["launches"] != g["cuts_formed"] or g["launches"] <= 0):
                problems.append(f"rank {r}: {g['launches']} launches for "
                                f"{g['cuts_formed']} cuts")
            if 2 * g["obs_bytes"] != whole[phase]:
                problems.append(f"rank {r}: {g['obs_bytes']} bytes of "
                                f"observation columns, not half of "
                                f"{whole[phase]}")
            if f"rank {r} of 2: {ranks[r]['device']} ({card})" not in text \
                    and phase == "pgp2like_obs2":
                problems.append(f"rank {r} did not name its card")
        if phase == "pgp2like_obs2":
            if any(g["rc"] != 0 for g in rows) or rank1_files or \
                    "incumb.dat" not in files:
                problems.append(f"the CLI's files: {files}")
            exact, opt, gap = exact_check(pgp_solver, "pgp2like",
                                          np.asarray(rows[0]["incumb_x"]))
            out[phase] = {"exact_objective": exact, "optimum": opt,
                          "exact_gap": gap}
            if gap > GAP_LIMIT:
                problems.append(f"exact gap {gap}")
        else:
            out[phase] = {"unsharded": ref[phase]}
            if phase.startswith("spread") and \
                    w.unique_omegas <= rows[0]["shard"][1]:
                problems.append(f"{w.unique_omegas} observations fill only "
                                f"rank 0's columns {rows[0]['shard']}")
        out[phase].update(
            ranks=rows, unsharded_obs_bytes=whole[phase],
            bit_identical=all(g["incumb_x"] == w.incumb_x.tolist() and
                              g["incumb_est"] == w.incumb_est
                              for g in rows))
        if problems:
            fail(f"{phase}: {problems}")
    out["spread_b16_obs2"]["checkpoint_bytes"] = ranks[0]["checkpoint_bytes"]
    out["spread_b16_obs2_resume"] = resume_fields(
        [rk["spread_b16_obs2_resume"] for rk in ranks],
        [rk["spread_b16_obs2"] for rk in ranks], one, one_launches, one_s)
    out["obs2_torchrun_seconds"] = seconds
    return out


def resume_fields(rows, whole, one, one_launches, one_seconds):
    """spread_b16_obs2's resumes against its uninterrupted 1x2 run
    ``whole`` (per rank): over 1x2 (``rows``) bit for bit, and on a 1x1
    mesh (``one``) within 1e-8; launches = cuts formed after the
    checkpoint."""
    keys = ("iterations", "optimal", "unique_omegas", "pool_sizes",
            "incumb_x", "incumb_est", "cuts_formed")
    problems = []
    for r, (g, w) in enumerate(zip(rows, whole)):
        if any(g[k] != w[k] for k in keys):
            problems.append(f"rank {r}: the resumed run differs from the "
                            f"uninterrupted one ({g} vs {w})")
        if g["launches"] != g["cuts_formed"] - g["cuts_at"]:
            problems.append(f"rank {r}: {g['launches']} launches after the "
                            f"resume for {g['cuts_formed'] - g['cuts_at']} "
                            "cuts")
    w = whole[0]
    if (one.iterations, one.optimal, one.unique_omegas, one.pool_sizes) != \
            (w["iterations"], w["optimal"], w["unique_omegas"],
             w["pool_sizes"]) or \
            not within(one.incumb_x, w["incumb_x"], 1e-8) or \
            not within(one.incumb_est, w["incumb_est"], 1e-8):
        problems.append(f"the 1x1 resume differs: {rep_fields(one)} vs {w}")
    if one_launches != one.cuts_formed - rows[0]["cuts_at"]:
        problems.append(f"1x1: {one_launches} launches after the resume")
    if problems:
        fail(f"spread_b16_obs2_resume: {problems}")
    return {"ranks": rows, "bit_identical": True,
            "resume_1x1": {"launches": one_launches, "seconds": one_seconds,
                           **rep_fields(one),
                           "bit_identical": one.incumb_x.tolist() ==
                           w["incumb_x"] and one.incumb_est ==
                           w["incumb_est"]}}


def within(a, b, rtol) -> bool:
    return bool(np.allclose(a, b, rtol=rtol, atol=rtol))


def phase_cli_mesh(dev, seq):
    """Phase 16: the CLI's run of phase 15 over three ranks on the card,
    held against ``seq``, phase 15's RunResult."""
    out = {"ranks": []}
    with tempfile.TemporaryDirectory() as root:
        text, out["seconds_torchrun"], ranks = torchrun(
            "cli_pgp2like_m3_mesh", "--mesh-rank", root, CLI_REPS,
            MESH_TIMEOUT)
        written = {r: os.path.isdir(os.path.join(root, f"rank{r}",
                                                 "twoSD_torch"))
                   for r in range(CLI_REPS)}
        files = sorted(os.listdir(os.path.join(root, "rank0", "twoSD_torch",
                                               "pgp2like"))) \
            if written[0] else []
    out["files_rank0"] = files
    card = torch.cuda.get_device_name(dev)
    identical = True
    problems = []
    for rk in ranks:
        r = rk["rank"]
        if f"rank {r} of {CLI_REPS}: {rk['device']} ({card})" not in text:
            problems.append(f"rank {r} did not name its card")
        if rk["rc"] != 0 or rk["card"] != card or \
                not rk["device"].startswith("cuda"):
            problems.append(f"rank {r} ran on {rk['device']} ({rk['card']})")
        if rk["launches"] != rk["cuts_formed"] or rk["ran"] != [r]:
            problems.append(f"rank {r}: {rk['launches']} launches for "
                            f"{rk['cuts_formed']} cuts of {rk['ran']}")
        for got, want in zip(rk["replications"], seq.replications):
            if (got["iterations"], got["optimal"], got["unique_omegas"],
                    got["pool_sizes"]) != (want.iterations, want.optimal,
                                           want.unique_omegas,
                                           want.pool_sizes) or \
                    not within(got["incumb_x"], want.incumb_x, 1e-8) or \
                    not within(got["incumb_est"], want.incumb_est, 1e-8):
                problems.append(f"rank {r}: replication {got['rep']} "
                                "differs from phase 15")
            identical &= got["incumb_x"] == want.incumb_x.tolist() and \
                got["incumb_est"] == want.incumb_est
        ev = rk["sharded_eval"]
        (m, m2, ok, n), (m1, m21, ok1, n1) = ev["sharded"], ev["single"]
        if (ok, n) != (ok1, n1) or not np.isclose(m, m1, rtol=1e-10,
                                                   atol=0) or \
                not np.isclose(m2, m21, rtol=1e-8, atol=0):
            problems.append(f"rank {r}: sharded evaluation {ev}")
        out["ranks"].append({k: rk[k] for k in (
            "rank", "device", "card", "cli_seconds", "launches",
            "cuts_formed", "peak_allocated_bytes", "sharded_eval_seconds",
            "sharded_eval")})
    head = ranks[0]
    for got, want in zip(head["replications"], seq.replications):
        if not within(got["ub"], want.eval.mean, 1e-8):
            problems.append(f"replication {got['rep']}: UB {got['ub']} vs "
                            f"{want.eval.mean}")
    for what, x, ev in (("compromise", seq.compromise_x,
                         seq.compromise_eval),
                        ("average", seq.average_x, seq.average_eval)):
        if what + "_x" not in head or \
                not within(head[what + "_x"], x, 1e-6) or \
                not within(head[what + "_ub"], ev.mean, 1e-8):
            problems.append(f"the {what} differs from phase 15")
        out[what] = {"x": head.get(what + "_x"), "ub": head.get(what + "_ub")}
    if any("compromise_x" in rk for rk in ranks[1:]):
        problems.append("a rank other than 0 holds the compromise")
    if not written[0] or any(written[r] for r in range(1, CLI_REPS)) or \
            {"detailedResults.csv", "incumb.dat", "results.jsonl",
             "summary.dat"} - set(files):
        problems.append(f"result files: {written} {files}")
    out["bit_identical_to_phase_15"] = identical
    out["launches"] = sum(rk["launches"] for rk in ranks)
    if problems:
        fail(f"cli_pgp2like_m3_mesh: {problems} ({out})")
    return out


def phase_smps_native():
    """The native tokenizer against the pure-Python parser on every
    instance's core text and on stormlike's."""
    import dataclasses

    from stochasticdecomposition_torch.models.instances import INSTANCES
    from stochasticdecomposition_torch.models.suite import SUITE
    from stochasticdecomposition_torch.models.synthetic import (
        random_two_stage,
    )
    from stochasticdecomposition_torch.smps import core, native

    out = {"gpp_seconds": native.build(), "cases": {}}
    native.library()
    texts = {n: INSTANCES[n][0] for n in sorted(INSTANCES)}
    texts["stormlike"] = random_two_stage(**SUITE["stormlike"])[0]
    with tempfile.TemporaryDirectory() as tmp:
        for name, text in texts.items():
            path = os.path.join(tmp, f"{name}.cor")
            with open(path, "w") as fh:
                fh.write(text)
            t = time.monotonic()
            nat = core.read_core(path)
            t_nat = time.monotonic() - t
            t = time.monotonic()
            py = core.read_core(path, prefer_native=False)
            t_py = time.monotonic() - t
            for f in dataclasses.fields(nat):
                a, b = getattr(nat, f.name), getattr(py, f.name)
                equal = a.dtype == b.dtype and np.array_equal(a, b) \
                    if isinstance(a, np.ndarray) else a == b
                if not equal:
                    fail(f"smps_native: {name}: field {f.name} differs")
            out["cases"][name] = {"shape": list(nat.A.shape),
                                  "native_seconds": t_nat,
                                  "python_seconds": t_py}
    return out


def phase_storm(dev, flush):
    from stochasticdecomposition_torch.config import SDConfig

    # The default configuration's pool capacities (MAX_ITER=5000:
    # O=5120, L=S=7501), run for a fixed number of iterations.
    cfg = SDConfig(EVAL_FLAG=False, MAX_ITER=STORM_ITERS, MAX_OMEGA=5001,
                   MAX_LAMBDA=7501, MAX_SIGMA=7501)
    solver, res, launches, rec = run_sd("stormlike", dev, cfg)
    out = {"iterations": res.iterations, "sd_seconds": res.time_total,
           "seconds_per_iteration": res.time_total / max(res.iterations, 1),
           "launches": launches, "cuts_formed": res.cuts_formed,
           "lps": res.lp_count,
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
    out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    return out


def phase_partial_pricing(storm, x):
    """Phase 18: stormlike's second-stage LP (528 x 1259) at ``x`` with and
    without ``partial_pricing`` (its defaults: a window of 16 pivots, 256
    candidates): PP_LANES lanes of drawn observations warm from the mean
    observation's basis, as the evaluator solves them (phase 9 solved it
    at the same ``x``).  The same statuses and objectives within
    PP_OBJ_RTOL; pivots per LP and seconds of each; the result fields in
    which the first lanes' bits differ between the lane counts.  (The cold
    mean-observation solve with partial pricing reaches the iteration cap
    in both packages: scripts/torch_partial_pricing_storm.py.)"""
    from stochasticdecomposition_torch.core.update import (
        subproblem_rhs_cost_lanes,
    )
    from stochasticdecomposition_torch.ops.simplex import (
        STATUS_OPTIMAL, LPResult, solve_lp,
    )
    from stochasticdecomposition_torch.sampler import sample_omega

    pa = storm.pa
    dev = pa.c1.device
    x = torch.as_tensor(x, dtype=pa.c1.dtype, device=dev)

    def solve(rhs, cost, pp, **kw):
        torch.cuda.synchronize()
        t = time.monotonic()
        res = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs,
                       partial_pricing=pp, **kw)
        torch.cuda.synchronize()
        return res, time.monotonic() - t

    def fields(res, seconds):
        it = res.iters.double()
        return {"pivots_per_lp": float(it.mean()), "pivots_max": int(it.max()),
                "optimal": int(torch.sum(res.status == STATUS_OPTIMAL)),
                "seconds": seconds}

    def held(tag, full, part):
        ok = full.status == STATUS_OPTIMAL
        rel = torch.abs(full.obj - part.obj) / torch.clamp(
            torch.abs(full.obj), min=1.0)
        worst = float(torch.amax(torch.where(ok, rel, 0.0)))
        if not torch.equal(full.status, part.status) or \
                worst > PP_OBJ_RTOL or not bool(torch.all(ok)):
            fail(f"partial_pricing {tag}: statuses {full.status.tolist()[:8]}"
                 f" vs {part.status.tolist()[:8]}, objective rel {worst}")
        return worst

    basis, atup = storm.eval_batch_fn.mean_basis(x)
    gen = torch.Generator(device=dev).manual_seed(PP_SEED)
    w = sample_omega(storm.spec, gen, max(PP_LANES), dtype=pa.c1.dtype) - \
        pa.omega_mean[None]
    rhs, cost = subproblem_rhs_cost_lanes(pa, x, w)
    out = {"m": pa.D.shape[0], "n": pa.D.shape[1]}
    lanes = {}
    for W in PP_LANES:
        warm = dict(init_basis=basis.expand(W, -1),
                    init_at_upper=atup.expand(W, -1))
        for pp in (False, True):
            lanes[W, pp] = solve(rhs[:W], cost[:W], pp, **warm)
        out[f"lanes{W}"] = {
            "full": fields(*lanes[W, False]),
            "partial": fields(*lanes[W, True]),
            "objective_rel": held(f"{W} lanes", lanes[W, False][0],
                                  lanes[W, True][0])}
    # The fields in which the first lanes differ between the lane counts.
    n = min(PP_LANES)
    out["lane_count_differs_in"] = {
        ("partial" if pp else "full"): [
            f for f in LPResult._fields
            if not same(getattr(lanes[n, pp][0], f),
                        getattr(lanes[max(PP_LANES), pp][0], f)[:n])]
        for pp in (False, True)}
    return out


def phase_storm_b8(dev, flush):
    from stochasticdecomposition_torch.config import SDConfig

    B = 8
    cfg = SDConfig(EVAL_FLAG=False, SAMPLE_INCREMENT=B,
                   MAX_ITER=STORM_B8_STEPS * B, MAX_OMEGA=5001,
                   MAX_LAMBDA=7501, MAX_SIGMA=7501)
    solver, res, launches, rec = run_sd("stormlike", dev, cfg, lanes=True)
    steps = res.iterations // B
    lane_pivots = np.concatenate(rec.lanes)
    step_s = np.diff(rec.times)
    per_step_max = [int(np.max(x)) for x in rec.lanes]
    out = {"sample_increment": B, "samples": res.iterations, "steps": steps,
           "sd_seconds": res.time_total,
           "setup_seconds": res.time_setup,
           "seconds_per_step": (res.time_total - res.time_setup) /
           max(steps, 1),
           "step_seconds": step_s.tolist(),
           "warm_step_seconds_median": float(np.median(step_s[1:])),
           "lps": res.lp_count,
           "lps_per_second": res.lp_count / max(
               res.time_total - res.time_setup, 1e-9),
           "pivots_per_lp": res.lp_pivots / max(res.lp_count, 1),
           "lane_pivots_max": int(np.max(lane_pivots)),
           "lane_pivots_median": float(np.median(lane_pivots)),
           "lane_pivots_max_per_step": per_step_max,
           "lane_pivots_median_per_step": [float(np.median(x))
                                           for x in rec.lanes],
           "launches": launches, "cuts_formed": res.cuts_formed,
           "ipm_iters_per_master": res.qp_iters / max(steps, 1),
           "master_failures": res.master_failures,
           "incumb_est": res.incumb_est, "pools": res.pool_sizes}
    if steps != STORM_B8_STEPS:
        fail(f"stormlike_b8 ran {steps} of {STORM_B8_STEPS} steps")
    if res.master_failures:
        fail(f"stormlike_b8: {res.master_failures} uncertified masters")
    if not np.all(np.isfinite(res.incumb_x)):
        fail("stormlike_b8: non-finite incumbent")
    out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    out["rep1"], out["compromise"], launches1 = storm_compromise(solver, res)
    return out, solver, res, launches1


def storm_compromise(solver, res):
    """A second replication (RUN_SEED[1]) of the same steps, then the
    compromise of the two at full width: the batch QP must certify, and the
    compromise decision meet the first-stage rows and bounds.  Returns
    (replication fields, compromise fields, kernel launches of the second
    replication)."""
    from stochasticdecomposition_torch.core.compromise import (
        solve_compromise,
    )
    from stochasticdecomposition_torch.ops import argmax

    dev = solver.device
    torch.cuda.reset_peak_memory_stats(dev)
    argmax.launches = 0
    res1 = solver.solve_replication(1)
    torch.cuda.synchronize()
    launches = argmax.launches
    rep1 = {"samples": res1.iterations, "sd_seconds": res1.time_total,
            "launches": launches, "cuts_formed": res1.cuts_formed,
            "master_failures": res1.master_failures,
            "incumb_est": res1.incumb_est,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    if launches != res1.cuts_formed or res1.master_failures or \
            res1.iterations != res.iterations:
        fail(f"stormlike_b8 replication 1: {rep1}")
    qp = []
    t = time.monotonic()
    with recording_qp(qp):
        cx, ax = solve_compromise(solver.pa, [res.batch_entry,
                                              res1.batch_entry])
    comp = {"seconds": time.monotonic() - t, **qp[0],
            "n1": int(solver.pa.c1.shape[0]),
            "first_stage_rows": int(solver.pa.b1.shape[0]),
            "violation": first_stage_violation(solver.pa, cx),
            "average_violation": first_stage_violation(solver.pa, ax)}
    if len(qp) != 1 or not qp[0]["converged"] or \
            comp["violation"] > COMPROMISE_VIOLATION:
        fail(f"stormlike_b8 compromise: {comp}")
    return rep1, comp, launches


def eval_fields(solver, ev, seconds):
    """The evaluation's JSON fields; LPs and pivots count the lanes and the
    mean-observation solve."""
    fn = solver.eval_batch_fn
    lps = ev.count + ev.dropped + 1
    pivots = fn.pivots + fn.base_pivots
    return {"ub": ev.mean, "ci": [ev.ci_low, ev.ci_high], "stdev": ev.stdev,
            "error": ev.error, "count": ev.count, "dropped": ev.dropped,
            "seconds": seconds, "lps": lps,
            "lps_per_second": lps / max(seconds, 1e-9),
            "pivots": pivots, "base_pivots": fn.base_pivots,
            "pivots_per_second": pivots / max(seconds, 1e-9)}


def batched_cfg(name, batch):
    """SAMPLE_INCREMENT ``batch`` with pools sized by the finite support
    (omega) and a fixed 512 dual vertices, and room for a deep stop."""
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.models.extensive import scenario_count

    n = scenario_count(load_problem(name)._stoc)
    return SDConfig(EVAL_FLAG=True, SAMPLE_INCREMENT=batch, MAX_ITER=32768,
                    MAX_OMEGA=n, MAX_LAMBDA=512, MAX_SIGMA=512)


def phase_suite_stop(name, si, dev, flush, smi):
    """Phase 19a: suite instance ``name`` at SAMPLE_INCREMENT ``si`` to the
    certified stop through ``suite_to_stop.run`` (tolerance SUITE_TOL,
    CHECK_EVERY SUITE_CHECK_EVERY, pools derived from SUITE_MAX_ITER), its
    steady rate included: a statistical stop, no uncertified master, one
    kernel launch per cut formed (the replication's and the steady-rate
    run's), the kernel on the final height table equal to its plain
    version; then the incumbent evaluated on SUITE_EVAL_OBS observations
    (EVAL_ERROR 0): a finite UB, no lane dropped, within EVAL_LIMIT of the
    LB estimate.  Peak memory beside ``estimate_pool_bytes``."""
    from stochasticdecomposition_torch import suite_to_stop
    from stochasticdecomposition_torch.ops import argmax

    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    det = {}
    rec = Recorder(lanes=True)
    argmax.launches = 0
    line = suite_to_stop.run(name, tol=SUITE_TOL, si=si,
                             max_iter=SUITE_MAX_ITER,
                             check_every=SUITE_CHECK_EVERY, device=dev,
                             metrics=rec, details=det)
    torch.cuda.synchronize()
    launches = argmax.launches
    peak = torch.cuda.max_memory_allocated(dev)
    solver, res = det["solver"], det["result"]
    steady_cuts = det["steady_state"].cut_cnt
    steps = res.iterations // si
    # A call of the step is CHECK_EVERY steps; lane_iters holds the last
    # step's.  The first call's seconds would include the solver's set-up.
    call_s = np.diff(rec.times)[1:]
    out = {"line": line, "steps": steps, "sd_seconds": res.time_total,
           "seconds_per_step": res.time_total / max(steps, 1),
           "step_call_seconds_after_first": call_s.tolist(),
           "lane_pivots_max_per_call": [int(np.max(x)) for x in rec.lanes],
           "lane_pivots_median_per_call": [float(np.median(x))
                                           for x in rec.lanes],
           "steady_seconds_per_step": si / line["samples_per_s_steady"],
           "state_bytes": sum(v.nbytes for v in rec.last
                              if isinstance(v, torch.Tensor)),
           "launches": launches, "cuts_formed": res.cuts_formed,
           "steady_cuts_formed": steady_cuts, "lps": res.lp_count,
           "pivots_per_lp": res.lp_pivots / max(res.lp_count, 1),
           "ipm_iters_per_master": res.qp_iters / max(steps, 1),
           "full_tests": res.full_tests,
           "master_failures": res.master_failures,
           "caps": solver.caps._asdict(),
           "pool_bytes_estimate": solver.pool_bytes["total"],
           "peak_allocated_bytes": peak,
           "peak_above_start_bytes": peak - start, "nvidia_smi": smi}
    if not line["stopped_statistically"]:
        fail(f"{name}: no statistical stop before {SUITE_MAX_ITER} samples "
             f"({out})")
    if res.master_failures:
        fail(f"{name}: {res.master_failures} uncertified master solves")
    if launches != res.cuts_formed + steady_cuts or launches <= 0:
        fail(f"{name}: {launches} kernel launches for {res.cuts_formed} + "
             f"{steady_cuts} cuts formed")
    if not np.all(np.isfinite(res.incumb_x)):
        fail(f"{name}: non-finite incumbent")
    out["argmax_at_stop"] = kernel_at_stop(solver, rec.last, flush)
    del det, rec
    solver.cfg.EVAL_ERROR = 0.0
    solver.cfg.EVAL_BATCH = SUITE_EVAL_OBS
    t = time.monotonic()
    ev = solver.evaluate_x(res.incumb_x, max_obs=SUITE_EVAL_OBS)
    torch.cuda.synchronize()
    row = eval_fields(solver, ev, time.monotonic() - t)
    row["ub_vs_lb"] = abs(ev.mean - res.incumb_est) / abs(res.incumb_est)
    out["eval"] = row
    if not np.isfinite(ev.mean) or ev.dropped or \
            ev.count != SUITE_EVAL_OBS or row["ub_vs_lb"] > EVAL_LIMIT:
        fail(f"{name}: evaluation {row} (LB {res.incumb_est})")
    return out


def phase_suite_grid(dev):
    """Phase 19b: ``sweep.main(GRID)`` in process, GRID_ROWS rows: each
    certified with its exact gap within GAP_LIMIT, no ``ERROR`` row, the
    TSV and JSONL files parsed, one kernel launch per cut formed; then the
    grid's RERUN row again in a fresh solver (``sweep.run_one``): the
    incumbent, estimate and pools bit for bit the grid's."""
    from stochasticdecomposition_torch import sweep
    from stochasticdecomposition_torch.ops import argmax

    results = {}
    run_one = sweep.run_one

    def kept_run_one(name, tol, batch, *a, **kw):
        got = run_one(name, tol, batch, *a, **kw)
        results[name, tol, batch] = got[0]
        return got

    text = io.StringIO()
    argmax.launches = 0
    t = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp, \
            swapped(sweep, "run_one", kept_run_one), \
            contextlib.redirect_stdout(text):
        rc = sweep.main(GRID + ["-o", tmp])
        torch.cuda.synchronize()
        seconds = time.monotonic() - t
        tsv = open(os.path.join(tmp, "sweep_results.tsv")).read()
        jsonl = [json.loads(ln) for ln in
                 open(os.path.join(tmp, "sweep_results.jsonl"))]
    launches = argmax.launches
    cuts = sum(r.cuts_formed for r in results.values())
    header, *rows = tsv.splitlines()
    out = {"rc": rc, "seconds": seconds, "launches": launches,
           "cuts_formed": cuts, "rows": jsonl}
    if rc != 0 or header + "\n" != sweep.HEADER or len(rows) != GRID_ROWS \
            or any("ERROR" in r for r in rows) or len(jsonl) != GRID_ROWS:
        fail(f"sweep grid: {tsv}")
    for r in jsonl:
        if not r["optimal"] or r["exact_gap"] is None or \
                r["exact_gap"] > GAP_LIMIT:
            fail(f"sweep grid: row {r}")
    if launches != cuts or launches <= 0:
        fail(f"sweep grid: {launches} kernel launches for {cuts} cuts")

    first = results[RERUN]
    argmax.launches = 0
    again, _, wall, _, _ = sweep.run_one(*RERUN, GRID_MAX_ITER, False,
                                         device=dev)
    torch.cuda.synchronize()
    out["rerun"] = {"row": list(RERUN), "seconds": wall,
                    "launches": argmax.launches,
                    "cuts_formed": again.cuts_formed,
                    "incumb_est": again.incumb_est,
                    "pools": again.pool_sizes,
                    "identical": bool(
                        np.array_equal(again.incumb_x, first.incumb_x)
                        and again.incumb_est == first.incumb_est
                        and again.pool_sizes == first.pool_sizes
                        and again.iterations == first.iterations)}
    if not out["rerun"]["identical"]:
        fail(f"sweep rerun of {RERUN} differs: {again} != {first}")
    if argmax.launches != again.cuts_formed:
        fail(f"sweep rerun: {argmax.launches} kernel launches for "
             f"{again.cuts_formed} cuts")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py runs on a CUDA card")
    # The package must be importable from this checkout.
    from stochasticdecomposition_torch import runner
    from stochasticdecomposition_torch.config import SDConfig
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
    out = phase_smps_native()
    emit({"phase": "smps_native", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    kern = phase_kernel(dev)
    emit({"phase": "kernel", **kern, "seconds": time.monotonic() - t})
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    launches = {}
    t = time.monotonic()
    saves = []
    with tempfile.TemporaryDirectory() as ckdir:
        with swapped(runner, "save_state", timed(runner.save_state, saves)):
            out, solver, res, _ = phase_to_stop(
                "lands", dev, SDConfig(EVAL_FLAG=False), flush,
                checkpoint_every=CKPT_EVERY, checkpoint_dir=ckdir)
        out["checkpoint_seconds"] = sum(saves)
        out["sd_seconds_without_checkpoints"] = out["sd_seconds"] - sum(saves)
        out["checkpoint_bytes"] = [
            os.path.getsize(p) for p in
            sorted(glob.glob(os.path.join(ckdir, "rep00_k*.npz")))]
        launches["lands"] = out["launches"]
        out["resume"], launches["lands_resume"] = resume_check(solver, res,
                                                               ckdir)
    emit({"phase": "lands", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out, pgp_solver, pgp_res, _ = phase_to_stop(
        "pgp2like", dev, SDConfig(EVAL_FLAG=False), flush)
    launches["pgp2like"] = out["launches"]
    emit({"phase": "pgp2like", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out = phase_storm(dev, flush)
    launches["stormlike"] = out["launches"]
    emit({"phase": "stormlike", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out, solver, _, _ = phase_to_stop("randc", dev,
                                      SDConfig(EVAL_FLAG=False), flush)
    launches["randc"] = out["launches"]
    out["delta_piC_bytes"] = solver.pool_bytes["delta_piC"]
    emit({"phase": "randc", **out, "seconds": time.monotonic() - t})

    evals = {}
    for name, batch in (("lands", 16), ("pgp2like", 64)):
        phase = f"{name}_b{batch}"
        t = time.monotonic()
        out, solver, res, rec = phase_to_stop(
            name, dev, batched_cfg(name, batch), flush, via_run=True)
        launches[phase] = out["launches"]
        emit({"phase": phase, **out, "seconds": time.monotonic() - t})
        evals[name] = (solver, res, rec.eval_seconds)

    t = time.monotonic()
    out, storm, storm_res, launches["stormlike_b8_rep1"] = \
        phase_storm_b8(dev, flush)
    launches["stormlike_b8"] = out["launches"]
    emit({"phase": "stormlike_b8", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    ev_out = {}
    for name, (solver, res, seconds) in evals.items():
        ev = res.eval
        exact, _, _ = exact_check(solver, name, res.incumb_x)
        row = eval_fields(solver, ev, seconds)
        row["exact_objective"] = exact
        row["ub_vs_exact"] = abs(ev.mean - exact) / abs(exact)
        ev_out[name] = row
        if row["ub_vs_exact"] > EVAL_LIMIT:
            fail(f"eval {name}: UB {ev.mean} is off the exact objective "
                 f"{exact} by more than {EVAL_LIMIT}")
        if not ev.count >= solver.cfg.EVAL_MIN_ITER:
            fail(f"eval {name}: only {ev.count} observations")
    # A fixed 2 x 512 lanes on stormlike (no early stop: EVAL_ERROR 0).
    storm.cfg.EVAL_ERROR = 0.0
    storm.cfg.EVAL_BATCH = STORM_EVAL_LANES
    torch.cuda.reset_peak_memory_stats(dev)
    t_s = time.monotonic()
    ev = storm.evaluate_x(storm_res.incumb_x,
                          max_obs=2 * STORM_EVAL_LANES)
    torch.cuda.synchronize()
    row = eval_fields(storm, ev, time.monotonic() - t_s)
    row["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    # Again on the same draws: the mean observation's basis is kept, so
    # this times the 2 x 512 lanes alone.
    pivots = storm.eval_batch_fn.pivots
    t_s = time.monotonic()
    again = storm.evaluate_x(storm_res.incumb_x,
                             max_obs=2 * STORM_EVAL_LANES)
    torch.cuda.synchronize()
    row["lanes_seconds"] = time.monotonic() - t_s
    row["lanes_pivots"] = storm.eval_batch_fn.pivots - pivots
    row["lanes_lps_per_second"] = 2 * STORM_EVAL_LANES / row["lanes_seconds"]
    if again != ev:
        fail(f"eval stormlike: a second evaluation on the same draws "
             f"differs ({again} != {ev})")
    ev_out["stormlike"] = row
    if ev.count + ev.dropped != 2 * STORM_EVAL_LANES or \
            not np.isfinite(ev.mean):
        fail(f"eval stormlike: {ev}")
    emit({"phase": "eval", **ev_out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out = phase_partial_pricing(storm, storm_res.incumb_x)
    emit({"phase": "partial_pricing", **out, "nvidia_smi": smi,
          "seconds": time.monotonic() - t})
    # The phases below start from the flush buffer alone.
    del storm, storm_res, evals, solver, res, rec

    t = time.monotonic()
    out = phase_feastest(dev, flush)
    launches["feastest"] = out["launches"]
    emit({"phase": "feastest", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out, _, fleet_res, _ = phase_randcost("fleetminilike", dev,
                                          SDConfig(EVAL_FLAG=False), flush,
                                          True)
    if not out["certified"]:
        fail(f"fleetminilike: no certified stop before MAX_ITER ({out})")
    launches["fleetminilike"] = out["launches"]
    emit({"phase": "fleetminilike", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    # Its 5^20 x 5^4 scenarios are not enumerable: STOCH_CHECK instead.
    out, solver, baa_res, rec = phase_randcost("baa99-20like", dev,
                                               baa_cfg(), flush, False)
    out["stoch_check"] = stoch_check(solver, rec.last, STOCH_CHECK_OBS)
    del solver, rec
    launches["baa99-20like"] = out["launches"]
    emit({"phase": "baa99-20like", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out = phase_lands_lp(dev, flush)
    launches["lands_lp"] = out["launches"]
    emit({"phase": "lands_lp", **out, "seconds": time.monotonic() - t})

    t = time.monotonic()
    out = phase_intcap_miqp(dev, flush)
    launches["intcaplike_miqp"] = out["launches"]
    emit({"phase": "intcaplike_miqp", **out,
          "seconds": time.monotonic() - t})

    t = time.monotonic()
    out, cli_result = phase_cli(dev)
    launches["cli_pgp2like_m3"] = out["launches"]
    emit({"phase": "cli_pgp2like_m3", **out,
          "seconds": time.monotonic() - t})

    t = time.monotonic()
    out = phase_cli_mesh(dev, cli_result)
    for rk in out["ranks"]:
        launches[f"cli_pgp2like_m3_mesh_rank{rk['rank']}"] = rk["launches"]
    emit({"phase": "cli_pgp2like_m3_mesh", **out,
          "seconds": time.monotonic() - t})

    t = time.monotonic()
    outs = phase_obs2(dev, pgp_solver, pgp_res,
                      {"fleetminilike_obs2": fleet_res,
                       "baa99-20like_obs2": baa_res})
    torchrun_s = outs.pop("obs2_torchrun_seconds")
    for phase, out in outs.items():
        if "unsharded" in out:
            launches[phase + "_unsharded"] = out["unsharded"]["launches"]
        if "resume_1x1" in out:
            launches[phase + "_1x1"] = out["resume_1x1"]["launches"]
        for r, row in enumerate(out["ranks"]):
            launches[f"{phase}_rank{r}"] = row["launches"]
        emit({"phase": phase, **out, "torchrun_seconds": torchrun_s})
    emit({"phase": "obs2", "seconds": time.monotonic() - t})

    t = time.monotonic()
    at_suite_stop = {}
    for name, si in SUITE_STOPS:
        t_s = time.monotonic()
        out = phase_suite_stop(name, si, dev, flush, smi)
        launches[f"{name}_b{si}_stop"] = out["launches"]
        at_suite_stop[f"{name}_b{si}_stop"] = out["argmax_at_stop"]
        emit({"phase": f"{name}_b{si}_stop", **out,
              "seconds": time.monotonic() - t_s})
    t_s = time.monotonic()
    out = phase_suite_grid(dev)
    launches["sweep_grid"] = out["launches"]
    launches["sweep_rerun"] = out["rerun"]["launches"]
    emit({"phase": "sweep_grid", **out, "seconds": time.monotonic() - t_s})
    emit({"phase": "suite", "seconds": time.monotonic() - t})

    emit({"phase": "total", "seconds": time.monotonic() - t_all})
    print(smi, flush=True)
    full = kern["timed"]["full"]
    emit({"kernels": [{
        "name": "triple_masked_argmax", "route": "cuda",
        "source": "stochasticdecomposition_torch/csrc/triple_argmax.cu",
        "replaces": "stochasticdecomposition_tpu/ops/pallas_argmax.py:191",
        "launches": sum(launches.values()),
        "launches_by_phase": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "prefix_ms": {str(n): kern["timed"][f"prefix{n}"]["ms"]
                      for n in PREFIXES},
        "prefix_bound_ms": {str(n): kern["timed"][f"prefix{n}"]["bound_ms"]
                            for n in PREFIXES},
        "shard": {f"{S}x{w}": {k: kern["timed"][f"shard{w}"][k]
                               for k in ("ms", "plain_ms", "bound_ms")}
                  for S, w in SHARD_SHAPES},
        "at_suite_stop": at_suite_stop}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    rank_entry = {"--mesh-rank": mesh_rank, "--obs-rank": obs_rank}
    if sys.argv[1:2] and sys.argv[1] in rank_entry:
        # The rank joins the group (torchrun's environment) before the CLI
        # does, so that the group outlives the CLI's run, and leaves it
        # after its last collective.
        from stochasticdecomposition_torch.parallel import distributed
        distributed.maybe_initialize()
        rank_entry[sys.argv[1]](sys.argv[2])
        distributed.shutdown()
    else:
        main()
