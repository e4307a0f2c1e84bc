"""Algorithm configuration.

Mirrors the reference ``configType`` (reference: twoSD.h:29-61) and the
``config.sd`` key-value file format (parser at twoSD.c:152-254), including the
tolerance presets selected by the ``-t {l,n,t}`` command line flag
(twoSD.c:93-103).  Defaults below reproduce the shipped ``config.sd:1-136``.

The port's own copy of the JAX package's configuration: every key parses
the same way.  Keys that exist for the TPU's sake are accepted and change
nothing: SUBPROB_F32_PIVOT and EVAL_F32_PIVOT (the port pivots in f64, the
card's native type), SUBPROB_STAGED_BATCH (a guard against a TPU kernel
fault; the port solves all lanes in one pass, up to
ops/simplex.lane_cap, which is sized for the card's memory) and
MEMORY_BUDGET_GB.  Every MASTER_TYPE runs (the LP, MILP, QP and MIQP
masters), as do MULTIPLE_REP > 1 and COMPROMISE_PROB (``SDSolver.run``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

# Default seed banks shipped in the reference config.sd (config.sd:22-52, 64-93).
_DEFAULT_RUN_SEEDS: Tuple[int, ...] = (
    3554548844580680, 4650175399072632, 6070772756632709, 5451675876709589,
    5285327724846206, 5588857889468088, 1098833779416153, 6192593982049265,
    4756774140130874, 6784592265109609, 9728429908537680, 1163479388309571,
    3279282318700126, 8773753208032360, 9337302665697748, 4415169667296773,
    4220432037464045, 3554548844580680, 1814300451929103, 5339672949292608,
    5638710736762732, 3154245808720589, 2414929536171258, 7998609999427572,
    7080145164625719, 3612848862740490586, 7772725003305823, 5982768791029230,
    1395182510837913, 3735836402047426,
)
_DEFAULT_EVAL_SEEDS: Tuple[int, ...] = (
    2668655841019641, 8879657642464524, 1499740298834250, 8272809468603661,
    9321928632105101, 8879657642464524, 1646307759053034, 1397125657640682,
    3146928660304649, 6086062973158789, 4261811376433110, 5160431490422796,
    7210299483505433, 2742341912700425, 1085010081252686, 8513449869606798,
    7093281297971938, 7988825411001281, 4183664541491746, 3145719174690472,
    7565122826024890, 5245385869406164, 2209547377191484, 9707622650545090,
    3276474213926122, 3808908035978675, 7200786232212849811, 3531095045851544,
    8536356961121783, 4742397086462006,
)

# Master problem types (reference: config.sd:10-11 comment).
MASTER_LP = 0
MASTER_MILP = 1
MASTER_QP = 5
MASTER_MIQP = 7

# (EPSILON, SCAN_LEN) tolerance presets (reference: twoSD.c:93-103).
TOLERANCE_PRESETS = {
    "l": (0.01, 128),     # loose
    "n": (0.001, 256),    # nominal
    "t": (0.0001, 512),   # tight
}


@dataclasses.dataclass
class SDConfig:
    """Tunable parameters of the 2-SD algorithm (reference: twoSD.h:29-61)."""

    # Core tolerances / iteration control (config.sd:1-20).
    TOLERANCE: float = 0.001        # zero-identity / dedup tolerance
    MIN_ITER: int = 1
    MAX_ITER: int = 5000
    MASTER_TYPE: int = MASTER_QP
    CUT_MULT: int = 1
    TAU: int = 2                    # incumbent-cut refresh frequency
    MIN_QUAD_SCALAR: float = 0.001
    MAX_QUAD_SCALAR: float = 10000.0

    # Seeds (config.sd:22-52, 64-93). Entry 0 is the *active* seed, mirroring
    # the reference convention RUN_SEED[0] = RUN_SEED[rep+1] (algo.c:43-44).
    RUN_SEED: List[int] = dataclasses.field(
        default_factory=lambda: list(_DEFAULT_RUN_SEEDS))
    EVAL_SEED: List[int] = dataclasses.field(
        default_factory=lambda: list(_DEFAULT_EVAL_SEEDS))

    # Evaluation (config.sd:54-61).
    EVAL_FLAG: bool = True
    EVAL_MIN_ITER: int = 250
    EVAL_ERROR: float = 0.01

    # Incumbent update rules (config.sd:99-106; soln.c:36-52).
    R1: float = 0.2
    R2: float = 0.95
    R3: float = 2.0

    # Dual stability test (config.sd:108-115; cuts.c:112-128,171-182).
    DUAL_STABILITY: bool = True
    PI_EVAL_START: int = 0
    PI_CYCLE: int = 1

    # Optimality tests (config.sd:117-130; optimal.c).
    BOOTSTRAP_REP: int = 50
    PERCENT_PASS: float = 0.95
    PRE_EPSILON: float = 0.01
    EPSILON: float = 0.001
    SCAN_LEN: int = 256

    # Replications / compromise (config.sd:132-136).
    MULTIPLE_REP: int = 1
    COMPROMISE_PROB: bool = False

    # ---- Knobs without a reference equivalent ----
    # Number of fresh observations drawn per SD step. 1 reproduces the
    # reference's strictly sequential sampling (algo.c:145); >1 batch-samples
    # (the vestigial `-s` flag of sd_experiments.sh:11): k advances by the
    # batch, the B subproblems are solved as the lanes of one solve_lp call
    # and one candidate cut covers the enlarged sample.
    SAMPLE_INCREMENT: int = 1
    # Static pool capacities; None derives them from MAX_ITER the same way the
    # reference preallocates (setup.c:126,136-144).  Deep batched runs on
    # finite-support instances should set them from the support, so that the
    # pools follow the deduplicated observations, not the sample count.
    MAX_OMEGA: int | None = None
    MAX_LAMBDA: int | None = None
    MAX_SIGMA: int | None = None
    # Observation batch size for the out-of-sample evaluator (the lanes of
    # one solve_lp call).
    EVAL_BATCH: int = 512
    # The JAX package's f32 pivot loops for the evaluator and for the SD
    # subproblems (a TPU economy).  Accepted; the port pivots in f64.
    EVAL_F32_PIVOT: bool = False
    SUBPROB_F32_PIVOT: bool = False
    # Batched-mode proximal relaxation: on a non-improving step divide
    # quad_scalar by R2 once (False: per master solve, the reference's
    # literal rule, soln.c:50-51) or by R2**SAMPLE_INCREMENT (True: per
    # sample).
    QS_RELAX_PER_SAMPLE: bool = False
    # The JAX package's two-stage batched solve, a guard against a TPU
    # kernel fault (None: automatic there).  Accepted; the port solves all
    # lanes in one pass, up to ops/simplex.lane_cap lanes per pass.
    SUBPROB_STAGED_BATCH: bool | None = None
    # dtype for solver-critical state ("float64" strongly recommended).
    DTYPE: str = "float64"
    # Explicit lower bound on E[h(x, omega)] overriding the derived one
    # (the reference computes this in spAlgorithms' calcLowerBound).
    LOWER_BOUND: float | None = None
    # Basis pool capacity for the random-cost path (None -> MAX_ITER).
    MAX_BASES: int | None = None
    # Simplex iteration cap multiplier: max_iters = SIMPLEX_ITER_MULT*(m+n)+64.
    SIMPLEX_ITER_MULT: int = 4
    # Host stopping-check cadence: run CHECK_EVERY SD steps per call of
    # the step. 1 reproduces the reference's per-iteration optimality gate
    # (algo.c:130); larger values may overshoot the stop by up to
    # CHECK_EVERY-1 steps.
    CHECK_EVERY: int = 1
    # The JAX package's budget for its static pools; accepted, unused.
    MEMORY_BUDGET_GB: float = 12.0

    def __post_init__(self):
        # Mixed-integer masters (config.sd:10-11, twoSD.h:33; the reference
        # passes the type to CPLEX at master.c:41) run the branch-and-bound
        # wrapper (core/bnb.py) around the LP/QP relaxations.  The B&B must
        # see every master solve, so the fused-chunk cadence is pinned to 1.
        if self.MASTER_TYPE in (MASTER_MILP, MASTER_MIQP):
            if self.CHECK_EVERY != 1:
                raise ValueError(
                    "MASTER_TYPE 1/7 (MILP/MIQP) requires CHECK_EVERY=1: the "
                    "branch-and-bound master runs on the host after every "
                    "fused iteration")
        elif self.MASTER_TYPE not in (MASTER_LP, MASTER_QP):
            raise ValueError(
                f"unknown MASTER_TYPE={self.MASTER_TYPE}; use 0 (LP), "
                "1 (MILP), 5 (regularized QP) or 7 (MIQP)")
        if self.SAMPLE_INCREMENT < 1:
            raise ValueError("SAMPLE_INCREMENT must be >= 1")
        if self.EVAL_BATCH < 1:
            raise ValueError("EVAL_BATCH must be >= 1")
        if self.MULTIPLE_REP == 1:
            # A compromise problem needs >1 replication (twoSD.c:248-250).
            self.COMPROMISE_PROB = False
        if self.MULTIPLE_REP > min(len(self.RUN_SEED), len(self.EVAL_SEED)):
            raise ValueError(
                "Requesting more replications than the number of seeds provided.")

    def apply_tolerance_preset(self, level: str) -> "SDConfig":
        """Apply the loose/nominal/tight preset (reference: twoSD.c:93-103)."""
        if level not in TOLERANCE_PRESETS:
            raise ValueError(f"unknown tolerance preset {level!r}; use l/n/t")
        self.EPSILON, self.SCAN_LEN = TOLERANCE_PRESETS[level]
        return self

    def eff_scan_len(self) -> int:
        """Dual-stability window length in STEPS so it always spans the
        same number of SAMPLES at any SAMPLE_INCREMENT.

        The reference indexes the pi_ratio window by sample count
        (cuts.c:172 ``pi_ratio[numSamples % SCAN_LEN]``); in batched mode
        one ratio is produced per step of B samples, so the window is
        ceil(SCAN_LEN / B) steps — SCAN_LEN means the same sample history
        at any B, and batched runs certify at sample counts comparable to
        batch-1.  Floored at 8 entries: the variance gate (2e-6 threshold,
        cuts.c:366 analog) over 2-4 ratios is a statistically weak
        estimate that can flag stability prematurely at large B; 8
        entries keeps the pre-test's evidence meaningful (the bootstrap
        full test still follows either way) at the cost of the window
        spanning up to 8*B samples."""
        b = max(1, self.SAMPLE_INCREMENT)
        if b == 1:
            return self.SCAN_LEN
        return max(-(-self.SCAN_LEN // b), 8)

    # Derived capacities -------------------------------------------------
    def max_cuts(self, first_stage_cols: int) -> int:
        """maxCuts = CUT_MULT*cols + 3 (reference: setup.c:126)."""
        return self.CUT_MULT * first_stage_cols + 3

    def pool_capacity(self, num_rand_cost: int) -> int:
        """lambda/sigma/delta row capacity (reference: setup.c:136-139)."""
        if num_rand_cost > 0:
            return num_rand_cost * self.MAX_ITER + self.MAX_ITER // self.TAU + 1
        return self.MAX_ITER + self.MAX_ITER // self.TAU + 1


_INT_KEYS = {
    "MIN_ITER", "MAX_ITER", "MASTER_TYPE", "CUT_MULT", "TAU", "PI_EVAL_START",
    "PI_CYCLE", "SCAN_LEN", "EVAL_MIN_ITER", "BOOTSTRAP_REP", "MULTIPLE_REP",
    "SAMPLE_INCREMENT", "EVAL_BATCH", "MAX_OMEGA", "MAX_LAMBDA", "MAX_SIGMA",
    "SIMPLEX_ITER_MULT", "CHECK_EVERY",
}
_FLOAT_KEYS = {
    "TOLERANCE", "MIN_QUAD_SCALAR", "MAX_QUAD_SCALAR", "R1", "R2", "R3",
    "PERCENT_PASS", "EVAL_ERROR", "PRE_EPSILON", "EPSILON",
    "MEMORY_BUDGET_GB",
}
_BOOL_KEYS = {"EVAL_FLAG", "DUAL_STABILITY", "COMPROMISE_PROB",
              "SUBPROB_STAGED_BATCH", "SUBPROB_F32_PIVOT", "EVAL_F32_PIVOT"}


def load_config(path: str | Path) -> SDConfig:
    """Parse a ``config.sd`` key-value file (reference parser: twoSD.c:152-254).

    Lines are ``KEY value``; ``//`` starts a comment.  ``RUN_SEED`` and
    ``EVAL_SEED`` may appear repeatedly and accumulate into seed banks.
    """
    run_seeds: List[int] = []
    eval_seeds: List[int] = []
    overrides: dict = {}

    text = Path(path).read_text()
    for raw in text.splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        key = parts[0]
        if len(parts) < 2:
            raise ValueError(f"config line missing value: {raw!r}")
        val = parts[1]
        if key == "RUN_SEED":
            run_seeds.append(int(val))
        elif key == "EVAL_SEED":
            eval_seeds.append(int(val))
        elif key in _INT_KEYS:
            overrides[key] = int(val)
        elif key in _FLOAT_KEYS:
            overrides[key] = float(val)
        elif key in _BOOL_KEYS:
            overrides[key] = bool(int(val))
        elif key == "DTYPE":
            overrides[key] = val
        else:
            # Reference errors on unknown keys (twoSD.c:234-237).
            raise ValueError(f"unrecognized parameter in configuration file: {key}")

    if run_seeds:
        overrides["RUN_SEED"] = run_seeds
    if eval_seeds:
        overrides["EVAL_SEED"] = eval_seeds
    return SDConfig(**overrides)
