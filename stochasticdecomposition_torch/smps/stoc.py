"""SMPS stoch-file parser.

Replaces spAlgorithms ``readStoc`` (used at twoSD.c:272).  Supports the INDEP
(DISCRETE / NORMAL / UNIFORM) and BLOCKS DISCRETE sections, which is the
coverage the reference documents (reference README.md:23), plus SCENARIOS
sections (beyond the reference: several SIPLIB originals ship as SCENARIOS),
which are lowered at parse time to one BLOCKS-equivalent joint distribution —
each scenario resolves to a full outcome vector over the union of random
positions (inheriting unlisted values from its parent scenario, ROOT = core
values), so every downstream consumer (sampler, decomposition, extensive
form) sees ordinary block randomness.

Each random element is located by a (column, row) pair:
  * column == 'RHS' (or any name that is not a core column)  ->  RHS entry b_i
  * row == objective row                                     ->  cost entry d_j
  * otherwise                                                ->  matrix entry A_ij
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from stochasticdecomposition_torch.smps.core import CoreProblem, _tokens

KIND_RHS = "rhs"
KIND_MATRIX = "matrix"
KIND_COST = "cost"

DIST_DISCRETE = "discrete"
DIST_NORMAL = "normal"
DIST_UNIFORM = "uniform"
DIST_BLOCK = "block"


@dataclasses.dataclass
class RandomElement:
    """One scalar random position in the problem."""

    kind: str                      # rhs | matrix | cost
    row: int                       # core row index (-1 for cost elements)
    col: int                       # core col index (-1 for rhs elements)
    dist: str                      # discrete | normal | uniform | block
    # For DISCRETE: support values and probabilities.
    values: Optional[np.ndarray] = None
    probs: Optional[np.ndarray] = None
    # For NORMAL: (mean, variance); for UNIFORM: (lower, upper).
    p1: float = 0.0
    p2: float = 0.0
    block_id: int = -1             # index into StocData.blocks, or -1

    @property
    def mean(self) -> float:
        if self.dist == DIST_DISCRETE:
            return float(np.dot(self.values, self.probs))
        if self.dist == DIST_NORMAL:
            return self.p1
        if self.dist == DIST_UNIFORM:
            return 0.5 * (self.p1 + self.p2)
        raise ValueError(f"mean undefined for dist {self.dist} at element level")


@dataclasses.dataclass
class Block:
    """A BLOCKS DISCRETE joint distribution: outcomes over member elements."""

    name: str
    elem_indices: List[int]        # indices into StocData.elements
    outcomes: np.ndarray           # [n_outcomes, n_members]
    probs: np.ndarray              # [n_outcomes]


@dataclasses.dataclass
class StocData:
    elements: List[RandomElement]
    blocks: List[Block]

    @property
    def num_omega(self) -> int:
        return len(self.elements)

    def means(self) -> np.ndarray:
        out = np.zeros(len(self.elements))
        for i, el in enumerate(self.elements):
            if el.dist == DIST_BLOCK:
                blk = self.blocks[el.block_id]
                pos = blk.elem_indices.index(i)
                out[i] = float(np.dot(blk.outcomes[:, pos], blk.probs))
            else:
                out[i] = el.mean
        return out


def _locate(core: CoreProblem, col_tok: str, row_tok: str):
    """Classify a (col, row) token pair into (kind, row_idx, col_idx)."""
    if row_tok == core.obj_name:
        if col_tok not in core.col_index:
            raise ValueError(f"random cost for unknown column {col_tok}")
        return KIND_COST, -1, core.col_index[col_tok]
    if row_tok not in core.row_index:
        raise ValueError(f"stoch file references unknown row {row_tok}")
    r = core.row_index[row_tok]
    if col_tok in core.col_index:
        return KIND_MATRIX, r, core.col_index[col_tok]
    return KIND_RHS, r, -1


def read_stoc(path: str, core: CoreProblem) -> StocData:
    elements: List[RandomElement] = []
    blocks: List[Block] = []
    position: dict = {}            # (kind,row,col) -> element index

    section = None                 # (kind, dist)
    # DISCRETE accumulation state per element.
    disc_vals: dict = {}
    disc_probs: dict = {}
    # BLOCKS state.
    cur_block: Optional[dict] = None
    # SCENARIOS state: list of {name, parent, prob, over:{(kind,r,c): val}}.
    scenarios: List[dict] = []
    scen_positions: dict = {}      # (kind,r,c) -> first-seen order

    def _get_element(kind, r, c, dist) -> int:
        key = (kind, r, c)
        if key not in position:
            position[key] = len(elements)
            elements.append(RandomElement(kind=kind, row=r, col=c, dist=dist))
        return position[key]

    def _flush_block():
        nonlocal cur_block
        if cur_block is None:
            return
        names = cur_block["members"]        # list of element indices in order
        outs = np.array(cur_block["outcomes"])   # [n_out, n_members]
        probs = np.array(cur_block["probs"])
        blk = Block(cur_block["name"], names, outs, probs)
        for i in names:
            elements[i].block_id = len(blocks)
        blocks.append(blk)
        cur_block = None

    def _flush_scenarios():
        """Lower the accumulated SCENARIOS section to one Block.

        Every scenario becomes one joint outcome over the union of random
        positions; unlisted positions inherit the parent scenario's value
        (ROOT = the core problem's value), per the SMPS scenario-tree
        convention.  For a two-stage problem the branch period carries no
        extra information — inheritance already encodes shared history."""
        if not scenarios:
            return
        keys = list(scen_positions.keys())

        def base_val(key):
            kind, r, c = key
            if kind == KIND_RHS:
                return float(core.b[r])
            if kind == KIND_MATRIX:
                return float(core.A[r, c])
            return float(core.c[c])

        base = {k: base_val(k) for k in keys}
        resolved: dict = {}
        probs, outs = [], []
        for sc in scenarios:
            parent = sc["parent"]
            if parent.upper().strip("'\"") == "ROOT":
                vec = dict(base)
            elif parent in resolved:
                vec = dict(resolved[parent])
            else:
                raise ValueError(
                    f"scenario {sc['name']!r} branches from undefined "
                    f"parent {parent!r} (parents must be declared first)")
            vec.update(sc["over"])
            resolved[sc["name"]] = vec
            probs.append(sc["prob"])
            outs.append([vec[k] for k in keys])
        total = float(np.sum(probs))
        if not np.isclose(total, 1.0, atol=1e-6):
            raise ValueError(
                f"scenario probabilities sum to {total}, expected 1.0")

        elem_idx = []
        for kind, r, c in keys:
            elem_idx.append(_get_element(kind, r, c, DIST_BLOCK))
        blk = Block("__SCENARIOS__", elem_idx,
                    np.asarray(outs, dtype=float),
                    np.asarray(probs, dtype=float))
        for i in elem_idx:
            elements[i].block_id = len(blocks)
        blocks.append(blk)
        scenarios.clear()
        scen_positions.clear()

    def _flush_discrete():
        for idx, vals in disc_vals.items():
            elements[idx].values = np.array(vals)
            elements[idx].probs = np.array(disc_probs[idx])
            s = elements[idx].probs.sum()
            if not np.isclose(s, 1.0, atol=1e-6):
                raise ValueError(
                    f"discrete probabilities for element {idx} sum to {s}")
        disc_vals.clear()
        disc_probs.clear()

    with open(path) as fh:
        for raw in fh:
            if not raw.strip():
                continue
            toks = _tokens(raw)
            if not toks:
                continue
            if raw[0] not in (" ", "\t"):
                head = toks[0].upper()
                _flush_block()
                _flush_scenarios()
                if head == "STOCH":
                    continue
                if head == "ENDATA":
                    break
                if head == "INDEP":
                    dist = toks[1].upper()
                    if dist not in ("DISCRETE", "NORMAL", "UNIFORM"):
                        raise NotImplementedError(f"INDEP {dist} not supported")
                    section = ("INDEP", dist)
                elif head == "BLOCKS":
                    if toks[1].upper() != "DISCRETE":
                        raise NotImplementedError(f"BLOCKS {toks[1]} not supported")
                    section = ("BLOCKS", "DISCRETE")
                elif head == "SCENARIOS":
                    # Optional qualifier: DISCRETE (default) / REPLACE mode.
                    if len(toks) > 1 and toks[1].upper() not in (
                            "DISCRETE", "REPLACE"):
                        raise NotImplementedError(
                            f"SCENARIOS {toks[1]} not supported (only "
                            "DISCRETE/REPLACE values)")
                    section = ("SCENARIOS", "DISCRETE")
                else:
                    raise ValueError(f"unknown stoch-file section: {head}")
                continue

            if section is None:
                raise ValueError(f"data line outside any section: {raw!r}")

            if section[0] == "INDEP":
                dist = section[1]
                col_tok, row_tok = toks[0], toks[1]
                kind, r, c = _locate(core, col_tok, row_tok)
                if dist == "DISCRETE":
                    val = float(toks[2])
                    # 'col row value [period] prob'
                    prob = float(toks[4]) if len(toks) >= 5 else float(toks[3])
                    idx = _get_element(kind, r, c, DIST_DISCRETE)
                    disc_vals.setdefault(idx, []).append(val)
                    disc_probs.setdefault(idx, []).append(prob)
                elif dist == "NORMAL":
                    mean = float(toks[2])
                    var = float(toks[4]) if len(toks) >= 5 else float(toks[3])
                    idx = _get_element(kind, r, c, DIST_NORMAL)
                    elements[idx].p1, elements[idx].p2 = mean, var
                elif dist == "UNIFORM":
                    lo = float(toks[2])
                    hi = float(toks[4]) if len(toks) >= 5 else float(toks[3])
                    idx = _get_element(kind, r, c, DIST_UNIFORM)
                    elements[idx].p1, elements[idx].p2 = lo, hi
            elif section[0] == "BLOCKS":
                if toks[0].upper() == "BL":
                    # 'BL name [period] prob' starts a new outcome of a block.
                    bname = toks[1]
                    prob = float(toks[-1])
                    if cur_block is not None and cur_block["name"] != bname:
                        _flush_block()
                    if cur_block is None:
                        cur_block = {"name": bname, "members": [],
                                     "outcomes": [], "probs": [],
                                     "first_done": False}
                    if cur_block["outcomes"]:
                        cur_block["first_done"] = True
                    cur_block["probs"].append(prob)
                    # Start the outcome from the previous outcome's values
                    # (SMPS BLOCKS: unmentioned members keep prior values; for
                    # the first outcome, values must all be given).
                    if cur_block["outcomes"]:
                        cur_block["outcomes"].append(
                            list(cur_block["outcomes"][0]))
                    else:
                        cur_block["outcomes"].append([])
                else:
                    col_tok, row_tok, val = toks[0], toks[1], float(toks[2])
                    kind, r, c = _locate(core, col_tok, row_tok)
                    idx = _get_element(kind, r, c, DIST_BLOCK)
                    if not cur_block["first_done"]:
                        if idx not in cur_block["members"]:
                            cur_block["members"].append(idx)
                            for o in cur_block["outcomes"]:
                                o.append(0.0)
                    pos = cur_block["members"].index(idx)
                    cur_block["outcomes"][-1][pos] = val
            elif section[0] == "SCENARIOS":
                if toks[0].upper() == "SC":
                    # 'SC name parent prob [branch_period]'.
                    scenarios.append({"name": toks[1], "parent": toks[2],
                                      "prob": float(toks[3]), "over": {}})
                else:
                    if not scenarios:
                        raise ValueError(
                            f"scenario data line before any SC line: {raw!r}")
                    col_tok, row_tok, val = toks[0], toks[1], float(toks[2])
                    kind, r, c = _locate(core, col_tok, row_tok)
                    key = (kind, r, c)
                    scen_positions.setdefault(key, len(scen_positions))
                    scenarios[-1]["over"][key] = val

    _flush_block()
    _flush_scenarios()
    _flush_discrete()
    return StocData(elements=elements, blocks=blocks)
