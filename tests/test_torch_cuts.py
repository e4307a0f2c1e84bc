"""One cut in both packages from the same SD state.

From the JAX state after k = 5 and 20 steps of lands and pgp2like, both
packages dedup the next observation, solve its subproblem warm, run the
stochastic updates, form the SD cut (the port through its plain triple
argmax on the CPU) and add it to the pool.

Tolerances: counts, indices (istar, slot) and masks exact; alpha, beta,
heights and the cut pool 1e-9 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.core.cuts import add_cut, form_cut
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.core.update import (
    calc_omega, stochastic_updates, warm_solve_subproblem,
)
from stochasticdecomposition_tpu.core import cuts as jcuts
from stochasticdecomposition_tpu.core import update as jupd
from torch_common import CPU, jax_solver, jax_states, port_problem, \
    to_port_state

TOL = 1e-3          # SDConfig.TOLERANCE
CUT = dict(dual_stability=True, pi_eval_start=0, pi_cycle=1, scan_len=256)


def _jax_one_cut(pa, state, w, k):
    state, o_idx, new_o = jupd.calc_omega(state, w, TOL)
    res, state = jupd.warm_solve_subproblem(
        pa, state, state.candid_x, state.omega_vals[o_idx])
    state, _ = jupd.stochastic_updates(pa, state, res, o_idx, new_o, k, TOL)
    parts, state = jcuts.form_cut(pa, state, state.candid_x, k, **CUT)
    state, slot = jcuts.add_cut(pa, state, parts, k, incumbent=False, tol=TOL)
    return parts, state, slot


def _port_one_cut(pa, state, w, k):
    state = state._replace(k=k)
    state, o_idx, new_o = calc_omega(state, w, TOL)
    res, state = warm_solve_subproblem(pa, state, state.candid_x,
                                       state.omega_vals[o_idx])
    state, _ = stochastic_updates(pa, state, res, o_idx, new_o, k, TOL)
    parts, state = form_cut(pa, state, state.candid_x, k, **CUT)
    state, slot = add_cut(pa, state, parts, k, incumbent=False, tol=TOL)
    return parts, state, slot


@functools.lru_cache(maxsize=None)
def _setup(name):
    js = jax_solver(name, MAX_ITER=64)
    states, draws = jax_states(js, 20)
    return js, states, draws, stage_problem(port_problem(name), CPU)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
@pytest.mark.parametrize("k", [5, 20])
def test_one_cut_matches_jax(name, k):
    js, states, draws, pa = _setup(name)
    st = states[k]
    # The observation the next step would draw (centered).
    w = np.asarray(draws[k] if k < len(draws) else draws[-1]) - \
        np.asarray(js.pa.omega_mean)
    k1 = int(st.k) + 1
    jparts, jst, jslot = jax.jit(_jax_one_cut)(js.pa, st, jnp.asarray(w),
                                               jnp.int32(k1))
    parts, pst, slot = _port_one_cut(pa, to_port_state(st),
                                     torch.as_tensor(w), k1)

    for f in ("omega_cnt", "lambda_cnt", "sigma_cnt"):
        assert getattr(pst, f) == int(getattr(jst, f)), f
    assert parts.found == bool(jparts.found)
    np.testing.assert_array_equal(parts.istar.numpy(),
                                  np.asarray(jparts.istar))
    assert _rel(parts.alpha, jparts.alpha) <= 1e-9
    assert _rel(parts.beta, jparts.beta) <= 1e-9
    o = int(jst.omega_cnt)
    assert _rel(parts.height[:o], jparts.height[:o]) <= 1e-9
    assert slot == int(jslot)
    np.testing.assert_array_equal(pst.cut_mask.numpy(),
                                  np.asarray(jst.cut_mask))
    np.testing.assert_array_equal(pst.cut_ns.numpy(), np.asarray(jst.cut_ns))
    np.testing.assert_array_equal(pst.cut_istar.numpy(),
                                  np.asarray(jst.cut_istar))
    assert _rel(pst.cut_alpha, jst.cut_alpha) <= 1e-9
    assert _rel(pst.cut_beta, jst.cut_beta) <= 1e-9
    assert _rel(pst.delta_pib, jst.delta_pib) <= 1e-9
    assert _rel(pst.pi_ratio, jst.pi_ratio) <= 1e-9
    assert pst.dual_stable == bool(jst.dual_stable)
