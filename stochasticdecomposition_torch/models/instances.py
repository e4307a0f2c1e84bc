"""Built-in SMPS test instances.

The reference benchmark suite (pgp2, cep, storm, ssn, ... — README.md:57-59)
lives in the spAlgorithms/spInput repository which is not mounted; these
embedded instances provide the same roles: small classical 2-SLPs whose
extensive forms are solvable exactly for parity checks.

``lands``: the classical electricity-investment problem (Louveaux & Smeers),
3-scenario demand version — the standard small stochastic LP test case.
``pgp2like``: a power-generation-planning shaped instance (4 first-stage
capacities, 3 demand rows with independent discrete demands) in the spirit of
pgp2.  Objective values for parity tests come from the extensive form solved
by this framework's own LP kernel (models.extensive), not from memory.
"""

from __future__ import annotations

import io
import os
import tempfile

_LANDS_CORE = """NAME          LANDS
ROWS
 N  OBJ
 G  MINCAP
 L  BUDGET
 L  CAP1
 L  CAP2
 L  CAP3
 L  CAP4
 G  DEM1
 G  DEM2
 G  DEM3
COLUMNS
    X1        OBJ       10.0   MINCAP    1.0
    X1        BUDGET    10.0   CAP1      -1.0
    X2        OBJ       7.0    MINCAP    1.0
    X2        BUDGET    7.0    CAP2      -1.0
    X3        OBJ       16.0   MINCAP    1.0
    X3        BUDGET    16.0   CAP3      -1.0
    X4        OBJ       6.0    MINCAP    1.0
    X4        BUDGET    6.0    CAP4      -1.0
    Y11       OBJ       40.0   CAP1      1.0
    Y11       DEM1      1.0
    Y12       OBJ       24.0   CAP1      1.0
    Y12       DEM2      1.0
    Y13       OBJ       4.0    CAP1      1.0
    Y13       DEM3      1.0
    Y21       OBJ       45.0   CAP2      1.0
    Y21       DEM1      1.0
    Y22       OBJ       27.0   CAP2      1.0
    Y22       DEM2      1.0
    Y23       OBJ       4.5    CAP2      1.0
    Y23       DEM3      1.0
    Y31       OBJ       32.0   CAP3      1.0
    Y31       DEM1      1.0
    Y32       OBJ       19.2   CAP3      1.0
    Y32       DEM2      1.0
    Y33       OBJ       3.2    CAP3      1.0
    Y33       DEM3      1.0
    Y41       OBJ       55.0   CAP4      1.0
    Y41       DEM1      1.0
    Y42       OBJ       33.0   CAP4      1.0
    Y42       DEM2      1.0
    Y43       OBJ       5.5    CAP4      1.0
    Y43       DEM3      1.0
RHS
    RHS       MINCAP    12.0   BUDGET    120.0
    RHS       DEM1      5.0    DEM2      3.0
    RHS       DEM3      2.0
BOUNDS
ENDATA
"""

_LANDS_TIME = """TIME          LANDS
PERIODS       IMPLICIT
    X1        MINCAP    STAGE1
    Y11       CAP1      STAGE2
ENDATA
"""

_LANDS_STOC = """STOCH         LANDS
INDEP         DISCRETE
    RHS       DEM1      3.0    STAGE2    0.33333333333333
    RHS       DEM1      5.0    STAGE2    0.33333333333334
    RHS       DEM1      7.0    STAGE2    0.33333333333333
ENDATA
"""

# A pgp2-shaped power generation planning instance: choose generation
# capacity of 4 technologies; second stage dispatches against 3 random
# demands with a high-cost emergency source guaranteeing complete recourse.
_PGP2LIKE_CORE = """NAME          PGP2LIKE
ROWS
 N  OBJ
 L  BUDGET
 L  CAP1
 L  CAP2
 L  CAP3
 L  CAP4
 G  DEM1
 G  DEM2
 G  DEM3
COLUMNS
    X1        OBJ       4.0    BUDGET    1.0
    X1        CAP1      -1.0
    X2        OBJ       4.5    BUDGET    1.0
    X2        CAP2      -1.0
    X3        OBJ       3.2    BUDGET    1.0
    X3        CAP3      -1.0
    X4        OBJ       5.5    BUDGET    1.0
    X4        CAP4      -1.0
    Y11       OBJ       4.0    CAP1      1.0
    Y11       DEM1      1.0
    Y12       OBJ       5.5    CAP1      1.0
    Y12       DEM2      1.0
    Y13       OBJ       7.0    CAP1      1.0
    Y13       DEM3      1.0
    Y21       OBJ       6.0    CAP2      1.0
    Y21       DEM1      1.0
    Y22       OBJ       4.0    CAP2      1.0
    Y22       DEM2      1.0
    Y23       OBJ       3.0    CAP2      1.0
    Y23       DEM3      1.0
    Y31       OBJ       8.0    CAP3      1.0
    Y31       DEM1      1.0
    Y32       OBJ       6.5    CAP3      1.0
    Y32       DEM2      1.0
    Y33       OBJ       5.0    CAP3      1.0
    Y33       DEM3      1.0
    Y41       OBJ       7.0    CAP4      1.0
    Y41       DEM1      1.0
    Y42       OBJ       8.0    CAP4      1.0
    Y42       DEM2      1.0
    Y43       OBJ       4.5    CAP4      1.0
    Y43       DEM3      1.0
    S1        OBJ       50.0   DEM1      1.0
    S2        OBJ       50.0   DEM2      1.0
    S3        OBJ       50.0   DEM3      1.0
RHS
    RHS       BUDGET    40.0
    RHS       DEM1      5.0    DEM2      4.0
    RHS       DEM3      3.0
ENDATA
"""

_PGP2LIKE_TIME = """TIME          PGP2LIKE
PERIODS       IMPLICIT
    X1        BUDGET    STAGE1
    Y11       CAP1      STAGE2
ENDATA
"""

_PGP2LIKE_STOC = """STOCH         PGP2LIKE
INDEP         DISCRETE
    RHS       DEM1      3.0    STAGE2    0.25
    RHS       DEM1      5.0    STAGE2    0.50
    RHS       DEM1      7.0    STAGE2    0.25
    RHS       DEM2      2.0    STAGE2    0.30
    RHS       DEM2      4.0    STAGE2    0.40
    RHS       DEM2      6.0    STAGE2    0.30
    RHS       DEM3      1.0    STAGE2    0.20
    RHS       DEM3      3.0    STAGE2    0.60
    RHS       DEM3      5.0    STAGE2    0.20
ENDATA
"""

# An instance WITHOUT complete recourse: the subproblem
#   min y  s.t.  y <= x1  (CAPY),  y + x2 >= d(w)  (DEMY)
# is infeasible whenever x1 + x2 < d(w) — exercising the induced-feasibility
# cut machinery (cuts.c:398-567).  The implied feasibility cut is
# x1 + x2 >= max_w d(w) = 6.
_FEAS_CORE = """NAME          FEASTEST
ROWS
 N  OBJ
 G  MINX
 L  CAPY
 G  DEMY
COLUMNS
    X1        OBJ       1.5    MINX      1.0
    X1        CAPY      -1.0
    X2        OBJ       1.0    MINX      1.0
    X2        DEMY      1.0
    Y1        OBJ       1.0    CAPY      1.0
    Y1        DEMY      1.0
RHS
    RHS       MINX      2.0    DEMY      4.0
BOUNDS
 UP BND       X1        10.0
 UP BND       X2        10.0
ENDATA
"""

_FEAS_TIME = """TIME          FEASTEST
PERIODS       IMPLICIT
    X1        MINX      STAGE1
    Y1        CAPY      STAGE2
ENDATA
"""

_FEAS_STOC = """STOCH         FEASTEST
INDEP         DISCRETE
    RHS       DEMY      2.0    STAGE2    0.3
    RHS       DEMY      4.0    STAGE2    0.4
    RHS       DEMY      6.0    STAGE2    0.3
ENDATA
"""

# Integer capacity-expansion instance for the MILP/MIQP master modes
# (MASTER_TYPE 1/7, config.sd:10-11): two INTEGER first-stage capacities
# (SMPS MARKER INTORG/INTEND), continuous recourse with a penalty slack
# (complete recourse), 3-point random demand.  The EF-MIP optimum is
# brute-forceable by enumerating the 6x6 integer grid (tests/test_milp.py).
_INTCAP_CORE = """NAME          INTCAP
ROWS
 N  OBJ
 G  MINCAP
 L  CAP1
 L  CAP2
 G  DEM
COLUMNS
    MARKER                 'MARKER'                 'INTORG'
    X1        OBJ       3.0    MINCAP    1.0
    X1        CAP1      -1.0
    X2        OBJ       2.0    MINCAP    1.0
    X2        CAP2      -1.0
    MARKER                 'MARKER'                 'INTEND'
    Y1        OBJ       2.0    CAP1      1.0
    Y1        DEM       1.0
    Y2        OBJ       5.0    CAP2      1.0
    Y2        DEM       1.0
    S         OBJ       20.0   DEM       1.0
RHS
    RHS       MINCAP    1.0    DEM       2.0
BOUNDS
 UP BND       X1        5.0
 UP BND       X2        5.0
ENDATA
"""

_INTCAP_TIME = """TIME          INTCAP
PERIODS       IMPLICIT
    X1        MINCAP    STAGE1
    Y1        CAP1      STAGE2
ENDATA
"""

_INTCAP_STOC = """STOCH         INTCAP
INDEP         DISCRETE
    RHS       DEM       1.0    STAGE2    0.3
    RHS       DEM       2.0    STAGE2    0.4
    RHS       DEM       3.0    STAGE2    0.3
ENDATA
"""

INSTANCES = {
    "lands": (_LANDS_CORE, _LANDS_TIME, _LANDS_STOC),
    "pgp2like": (_PGP2LIKE_CORE, _PGP2LIKE_TIME, _PGP2LIKE_STOC),
    "feastest": (_FEAS_CORE, _FEAS_TIME, _FEAS_STOC),
    "intcaplike": (_INTCAP_CORE, _INTCAP_TIME, _INTCAP_STOC),
}


def load_instance(name: str):
    """Parse a built-in instance; returns (core, time, stoc) parse trees."""
    from stochasticdecomposition_torch.smps import read_core, read_stoc, read_time

    core_s, time_s, stoc_s = INSTANCES[name]
    with tempfile.TemporaryDirectory() as td:
        cp = os.path.join(td, "p.cor")
        tp = os.path.join(td, "p.tim")
        sp = os.path.join(td, "p.sto")
        for p, s in ((cp, core_s), (tp, time_s), (sp, stoc_s)):
            with open(p, "w") as fh:
                fh.write(s)
        core = read_core(cp)
        tim = read_time(tp, core)
        stoc = read_stoc(sp, core)
    return core, tim, stoc
