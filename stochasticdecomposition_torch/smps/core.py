"""MPS core-file parser.

Replaces spAlgorithms ``readCore`` (used at twoSD.c:259).  Produces a dense
row-major representation (the problems in the 2-SLP benchmark family are small
enough that dense staging is the right trade for TPU: everything downstream
wants static shapes and matmuls).

Supported: free-format MPS with ROWS / COLUMNS / RHS / RANGES / BOUNDS
sections, integer markers (recorded, solved as LP relaxation — the reference
behaves the same way, setup.c:46-50), and OBJSENSE.  ``read_core`` reads with
the native C++ tokenizer (``smps/native.py``); this module's pure-Python
parser is its reference semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# Row senses, encoded as integers.
SENSE_LE = -1   # 'L'
SENSE_EQ = 0    # 'E'
SENSE_GE = 1    # 'G'

_SENSE_CODE = {"L": SENSE_LE, "E": SENSE_EQ, "G": SENSE_GE}

INF = float("inf")


@dataclasses.dataclass
class CoreProblem:
    """Parsed core problem  min c'x  s.t.  A x {<=,=,>=} b,  l <= x <= u."""

    name: str
    objsense: int                      # +1 minimize, -1 maximize
    obj_name: str
    row_names: List[str]               # constraint rows only (objective excluded)
    col_names: List[str]
    row_index: Dict[str, int]
    col_index: Dict[str, int]
    A: np.ndarray                      # [m, n] dense
    b: np.ndarray                      # [m]
    sense: np.ndarray                  # [m] in {-1, 0, +1}
    c: np.ndarray                      # [n]
    obj_constant: float                # from RHS entry on the objective row (negated)
    lb: np.ndarray                     # [n]
    ub: np.ndarray                     # [n]
    is_integer: np.ndarray             # [n] bool
    # RANGES rows, reformulated at parse time into equality rows with one
    # bounded slack column each (appended after the structural columns):
    # list of (row_idx, slack_col_idx).  Empty when the file has no RANGES.
    range_slacks: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def n_rows(self) -> int:
        return len(self.row_names)

    @property
    def n_cols(self) -> int:
        return len(self.col_names)


def _tokens(line: str) -> List[str]:
    # '$' and '*' start comments in MPS.
    for marker in ("$", "*"):
        idx = line.find(marker)
        if idx >= 0:
            line = line[:idx]
    return line.split()


def read_core(path: str, prefer_native: bool = True) -> CoreProblem:
    """Parse an MPS core file: with the native C++ tokenizer
    (``smps/native.py``, built with g++ at first use; raises if it cannot
    be built), or with the pure-Python one when ``prefer_native`` is
    False."""
    if prefer_native:
        from stochasticdecomposition_torch.smps.native import (
            read_core_native,
        )
        return read_core_native(path)
    return _read_core_py(path)


def _read_core_py(path: str) -> CoreProblem:
    name = ""
    objsense = 1
    obj_name = None
    row_names: List[str] = []
    row_sense: List[int] = []
    row_index: Dict[str, int] = {}
    col_names: List[str] = []
    col_index: Dict[str, int] = {}
    entries: List[tuple] = []          # (col_idx, row_idx, val); row_idx -1 = objective
    rhs: Dict[int, float] = {}
    ranges: Dict[int, float] = {}
    obj_constant = 0.0
    c_entries: Dict[int, float] = {}
    bounds: List[tuple] = []           # (type, col_idx, val)
    integer_cols: set = set()

    section = None
    in_integer = False

    with open(path) as fh:
        for raw in fh:
            if not raw.strip():
                continue
            if raw[0] not in (" ", "\t"):
                toks = _tokens(raw)
                if not toks:
                    continue
                head = toks[0].upper()
                if head == "NAME":
                    name = toks[1] if len(toks) > 1 else ""
                    section = None
                elif head == "OBJSENSE":
                    section = "OBJSENSE"
                elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS"):
                    section = head
                elif head == "ENDATA":
                    break
                else:
                    raise ValueError(f"unknown MPS section header: {head}")
                continue

            toks = _tokens(raw)
            if not toks:
                continue

            if section == "OBJSENSE":
                objsense = -1 if toks[0].upper().startswith("MAX") else 1
            elif section == "ROWS":
                rtype, rname = toks[0].upper(), toks[1]
                if rtype == "N":
                    if obj_name is None:
                        obj_name = rname        # first N row is the objective
                    # further free rows are ignored, like most MPS readers
                else:
                    row_index[rname] = len(row_names)
                    row_names.append(rname)
                    row_sense.append(_SENSE_CODE[rtype])
            elif section == "COLUMNS":
                if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
                    marker = toks[2].upper().strip("'")
                    if marker == "INTORG":
                        in_integer = True
                    elif marker == "INTEND":
                        in_integer = False
                    continue
                cname = toks[0]
                if cname not in col_index:
                    col_index[cname] = len(col_names)
                    col_names.append(cname)
                    if in_integer:
                        integer_cols.add(col_index[cname])
                j = col_index[cname]
                pairs = toks[1:]
                for k in range(0, len(pairs) - 1, 2):
                    rname, val = pairs[k], float(pairs[k + 1])
                    if rname == obj_name:
                        c_entries[j] = c_entries.get(j, 0.0) + val
                    elif rname in row_index:
                        entries.append((j, row_index[rname], val))
                    else:
                        raise ValueError(f"COLUMNS references unknown row {rname}")
            elif section == "RHS":
                pairs = toks[1:] if len(toks) % 2 == 1 else toks
                # RHS lines are '<setname> <row> <val> [<row> <val>]'; some files
                # omit the set name, hence the parity heuristic above.
                for k in range(0, len(pairs) - 1, 2):
                    rname, val = pairs[k], float(pairs[k + 1])
                    if rname == obj_name:
                        obj_constant = -val
                    elif rname in row_index:
                        rhs[row_index[rname]] = val
                    else:
                        raise ValueError(f"RHS references unknown row {rname}")
            elif section == "RANGES":
                pairs = toks[1:] if len(toks) % 2 == 1 else toks
                for k in range(0, len(pairs) - 1, 2):
                    rname, val = pairs[k], float(pairs[k + 1])
                    if rname not in row_index:
                        raise ValueError(
                            f"RANGES references unknown row {rname}")
                    ranges[row_index[rname]] = val
            elif section == "BOUNDS":
                btype = toks[0].upper()
                if btype in ("FR", "MI", "PL", "BV"):
                    cname = toks[-1] if toks[-1] in col_index else toks[2 if len(toks) > 2 else 1]
                    bounds.append((btype, col_index[cname], 0.0))
                else:
                    # '<type> <setname> <col> <val>' or '<type> <col> <val>'
                    if len(toks) >= 4:
                        cname, val = toks[2], float(toks[3])
                    else:
                        cname, val = toks[1], float(toks[2])
                    bounds.append((btype, col_index[cname], val))
            else:
                raise ValueError(f"data line outside any section: {raw!r}")

    if obj_name is None:
        raise ValueError("core file has no objective (N) row")

    m, n = len(row_names), len(col_names)
    A = np.zeros((m, n))
    for j, i, v in entries:
        A[i, j] += v
    b = np.zeros(m)
    for i, v in rhs.items():
        b[i] = v
    sense = np.array(row_sense, dtype=np.int32)
    c = np.zeros(n)
    for j, v in c_entries.items():
        c[j] = v

    lb = np.zeros(n)
    ub = np.full(n, INF)
    for btype, j, v in bounds:
        if btype == "UP":
            ub[j] = v
            if v < 0 and lb[j] == 0.0:
                # MPS convention: negative UP with default lower bound frees it.
                lb[j] = -INF
        elif btype == "LO":
            lb[j] = v
        elif btype == "FX":
            lb[j] = ub[j] = v
        elif btype == "FR":
            lb[j], ub[j] = -INF, INF
        elif btype == "MI":
            lb[j] = -INF
        elif btype == "PL":
            ub[j] = INF
        elif btype == "BV":
            lb[j], ub[j] = 0.0, 1.0
            integer_cols.add(j)
        elif btype == "LI":
            lb[j] = v
            integer_cols.add(j)
        elif btype == "UI":
            ub[j] = v
            integer_cols.add(j)
        else:
            raise ValueError(f"unknown bound type {btype}")

    # RANGES (standard MPS two-sided rows): row i with rhs r and range v
    # becomes a two-sided constraint
    #   L row:          r - |v| <= ax <= r
    #   G row:          r       <= ax <= r + |v|
    #   E row (v >= 0): r       <= ax <= r + v
    #   E row (v <  0): r - |v| <= ax <= r
    # Reformulated here as an EQUALITY with one bounded slack column:
    #   ax + s*coef = r,  s in [0, |v|],  coef = +1 (upper side at r) or
    #   -1 (lower side at r).  The rhs stays the ORIGINAL r, so a STOCH
    # RHS entry on a ranged row shifts the whole interval (CPLEX ranged-row
    # semantics under RHS randomization); the reference reader (spAlgorithms
    # smps.h, used at twoSD.c:259) is a general MPS reader with the same
    # RANGES support.  Slack columns are appended after the structural
    # columns (second stage under the time split; a first-stage ranged row
    # fails loudly in prob.decompose's cross-stage check).
    A, b, sense, c, lb, ub, col_names, col_index, range_slacks = \
        _apply_ranges(ranges, row_names, A, b, sense, c, lb, ub,
                      col_names, col_index)

    n = len(col_names)
    is_int = np.zeros(n, dtype=bool)
    for j in integer_cols:
        is_int[j] = True

    if objsense == -1:
        c = -c

    return CoreProblem(
        name=name, objsense=1, obj_name=obj_name,
        row_names=row_names, col_names=col_names,
        row_index=row_index, col_index=col_index,
        A=A, b=b, sense=sense, c=c, obj_constant=obj_constant,
        lb=lb, ub=ub, is_integer=is_int, range_slacks=range_slacks,
    )


def _apply_ranges(ranges, row_names, A, b, sense, c, lb, ub,
                  col_names, col_index):
    """Lower RANGES entries to equality-with-bounded-slack form (see the
    caller comment for semantics).  Deterministic order: ascending row."""
    range_slacks: List[tuple] = []
    if not ranges:
        return A, b, sense, c, lb, ub, col_names, col_index, range_slacks
    rows = sorted(ranges)
    m, n = A.shape
    S = np.zeros((m, len(rows)))
    s_lb = np.zeros(len(rows))
    s_ub = np.zeros(len(rows))
    for t, i in enumerate(rows):
        v = ranges[i]
        width = abs(v)
        if sense[i] == SENSE_LE:
            coef = 1.0                       # ax = r - s  ->  [r-|v|, r]
        elif sense[i] == SENSE_GE:
            coef = -1.0                      # ax = r + s  ->  [r, r+|v|]
        else:                                # E row: sign of v picks a side
            coef = -1.0 if v >= 0 else 1.0
        S[i, t] = coef
        s_ub[t] = width
        sense[i] = SENSE_EQ
        sname = f"{row_names[i]}$RNG"
        col_index[sname] = n + t
        col_names.append(sname)
        range_slacks.append((int(i), n + t))
    A = np.hstack([A, S])
    c = np.concatenate([c, np.zeros(len(rows))])
    lb = np.concatenate([lb, s_lb])
    ub = np.concatenate([ub, s_ub])
    return A, b, sense, c, lb, ub, col_names, col_index, range_slacks
