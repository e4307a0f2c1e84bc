"""SMPS time-file parser (stage decomposition boundaries).

Replaces spAlgorithms ``readTime`` (used at twoSD.c:266).  Only the IMPLICIT
form is supported — each PERIODS entry names the first column and first row of
a stage, in core-file order.  Two stages are required by the 2-SD algorithm.
"""

from __future__ import annotations

import dataclasses
from typing import List

from stochasticdecomposition_torch.smps.core import CoreProblem, _tokens


@dataclasses.dataclass
class TimeData:
    period_names: List[str]
    col_starts: List[int]   # first column index of each period
    row_starts: List[int]   # first row index of each period

    @property
    def num_stages(self) -> int:
        return len(self.period_names)


def read_time(path: str, core: CoreProblem) -> TimeData:
    period_names: List[str] = []
    col_starts: List[int] = []
    row_starts: List[int] = []
    section = None

    with open(path) as fh:
        for raw in fh:
            if not raw.strip():
                continue
            if raw[0] not in (" ", "\t"):
                toks = _tokens(raw)
                if not toks:
                    continue
                head = toks[0].upper()
                if head == "TIME":
                    section = None
                elif head == "PERIODS":
                    if len(toks) > 1 and toks[1].upper() not in ("IMPLICIT", "LP"):
                        raise NotImplementedError(
                            f"only IMPLICIT time files supported, got {toks[1]}")
                    section = "PERIODS"
                elif head == "ENDATA":
                    break
                else:
                    raise ValueError(f"unknown time-file section: {head}")
                continue
            if section == "PERIODS":
                toks = _tokens(raw)
                col, row, period = toks[0], toks[1], toks[2]
                period_names.append(period)
                col_starts.append(core.col_index[col])
                # The first stage's row marker may name the objective row.
                if row == core.obj_name:
                    row_starts.append(0)
                else:
                    row_starts.append(core.row_index[row])

    if len(period_names) != 2:
        raise NotImplementedError(
            f"2-SD requires exactly two stages, time file has {len(period_names)}")
    if col_starts[0] != 0:
        raise ValueError("first period must start at the first column")
    return TimeData(period_names, col_starts, row_starts)
