"""Problem data, SD state and compromise entries carried across from numpy
arrays.

``problem_from_numpy``, ``state_from_numpy`` and ``batch_entry_from_numpy``
take ``{field: np.ndarray}`` — as a test builds it from another
implementation's containers with ``np.asarray`` — and return the port's
``ProblemArrays`` / ``SDState`` on a device, or its host-side
``BatchEntry``, so two implementations can start from the same state at any
step or solve the same compromise.  Fields the port does not carry (the PRNG
key, the feasibility cut count, which the port reads off ``fcut_mask``) are
ignored; a missing field raises.  ``utils/checkpoint.load_checkpoint``
reads the JAX package's checkpoints by the same rules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stochasticdecomposition_torch.core.compromise import BatchEntry
from stochasticdecomposition_torch.core.state import ProblemArrays, SDState

_INT_FIELDS = {
    "sense1", "sense2", "rv_b_rows", "rv_C_rows", "rv_C_cols", "rv_d_cols",
    "lambda_rows", "C_cols", "lam_pos_C", "C_cols_rand", "omega_w",
    "sigma_lidx", "sigma_ck", "cut_ns", "cut_omega_cnt", "cut_istar",
    "warm_basis", "basis_sigma0", "basis_sigma_idx", "basis_ck",
    "lane_iters",
}
_INT8_FIELDS = {"basis_cstat", "basis_rstat"}
_BOOL_TENSORS = {"sigma_feas", "cut_mask", "fcut_mask", "warm_atup", "int1",
                 "basis_present", "basis_feas", "obs_feas"}
_PY_INTS = {"k", "lp_cnt", "lp_pivots", "qp_iters", "omega_cnt",
            "lambda_cnt", "sigma_cnt", "i_cut_idx", "i_cut_updt",
            "ratio_cnt", "last_o_idx", "cut_cnt", "basis_cnt", "feas_cnt"}
_PY_BOOLS = {"incumb_chg", "dual_stable", "sp_feas", "master_ok", "cut_ok",
             "lb_nontrivial", "opt_mode", "infeas_incumb"}
_PY_FLOATS = {"lb"}
_PY_INT_PAIRS = {"f_updt"}


def _convert(name, value, device, dtype):
    if name in _PY_INTS:
        return int(np.asarray(value))
    if name in _PY_BOOLS:
        return bool(np.asarray(value))
    if name in _PY_FLOATS:
        return float(np.asarray(value))
    if name in _PY_INT_PAIRS:
        return tuple(int(v) for v in np.asarray(value))
    a = np.array(value)            # a writable copy: pools are updated in place
    if name in _INT_FIELDS:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if name in _INT8_FIELDS:
        return torch.as_tensor(a.astype(np.int8), device=device)
    if name in _BOOL_TENSORS:
        return torch.as_tensor(a.astype(bool), device=device)
    return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)


def _build(cls, fields: dict, device, dtype):
    missing = [f for f in cls._fields
               if f not in fields and f not in cls._field_defaults]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    dev = torch.device(device)
    return cls(**{f: _convert(f, fields[f], dev, dtype)
                  for f in cls._fields if f in fields})


def problem_from_numpy(fields: dict, device="cpu",
                       dtype=torch.float64) -> ProblemArrays:
    return _build(ProblemArrays, fields, device, dtype)


def state_from_numpy(fields: dict, device="cpu",
                     dtype=torch.float64) -> SDState:
    return _build(SDState, fields, device, dtype)



def batch_entry_from_numpy(fields: dict) -> BatchEntry:
    """A compromise entry from another implementation's ``BatchEntry``
    fields, in the port's types (host arrays, copies)."""
    missing = [f.name for f in dataclasses.fields(BatchEntry)
               if f.name not in fields]
    if missing:
        raise KeyError(f"BatchEntry fields missing: {missing}")
    return BatchEntry(
        incumb_x=np.array(fields["incumb_x"], np.float64),
        k=int(fields["k"]), quad_scalar=float(fields["quad_scalar"]),
        obj_lb=float(fields["obj_lb"]),
        cut_alpha=np.array(fields["cut_alpha"], np.float64),
        cut_beta=np.array(fields["cut_beta"], np.float64),
        cut_ns=np.array(fields["cut_ns"], np.int64),
        cut_mask=np.array(fields["cut_mask"], bool),
        fcut_alpha=np.array(fields["fcut_alpha"], np.float64),
        fcut_beta=np.array(fields["fcut_beta"], np.float64),
        fcut_mask=np.array(fields["fcut_mask"], bool))
