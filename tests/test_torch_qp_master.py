"""The port's interior-point QP and QP master against the JAX package's.

solve_qp on the cases of tests/test_qp.py (KKT residuals, closed forms,
masked rows) and against the JAX solve_qp; build_and_solve_master on the
same SD state, carried across with ``state_from_numpy`` after 10 JAX steps.

Tolerances: objectives 1e-9 relative; primal points 1e-7 absolute (two
interior-point runs whose KKT solves differ in rounding — LU in the port,
Gauss-Jordan in the JAX package — stop at the same certified point up to
the polish's accuracy); KKT residuals 1e-6, as tests/test_qp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.core.master import build_and_solve_master
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.ops.qp import solve_qp
from stochasticdecomposition_tpu.core.master import (
    build_and_solve_master as jax_master,
)
from stochasticdecomposition_tpu.ops.qp import solve_qp as jax_solve_qp
from torch_common import CPU, jax_solver, jax_states, port_problem, \
    to_port_state

t = torch.as_tensor


def _random_qp_shaped(rng, n, me, mi):
    L = rng.normal(size=(n, n))
    Q = L @ L.T + 0.1 * np.eye(n)
    c = rng.normal(size=n)
    A = rng.normal(size=(me, n))
    G = rng.normal(size=(mi, n))
    v0 = rng.normal(size=n)
    h = G @ v0 + rng.uniform(0.1, 2.0, size=mi)
    b = A @ v0 if me else np.zeros(0)
    return Q, c, A.reshape(me, n), b, G, h


_jax_qp = jax.jit(jax_solve_qp)


@pytest.mark.parametrize("shape", [(6, 0, 8), (5, 2, 9)])
def test_random_qp_kkt_and_jax(shape):
    """(n, me, mi) fixed per case so one compiled JAX solver serves its
    draws."""
    rng = np.random.default_rng(sum(shape))
    for _ in range(4):
        Q, c, A, b, G, h = qp = _random_qp_shaped(rng, *shape)
        me = A.shape[0]
        res = solve_qp(*(t(a) for a in qp))
        assert res.converged
        v, y, z = res.v.numpy(), res.y.numpy(), res.z.numpy()
        stat = Q @ v + c + (A.T @ y if me else 0) + G.T @ z
        assert np.max(np.abs(stat)) < 1e-6
        assert np.max(G @ v - h) < 1e-6
        if me:
            assert np.max(np.abs(A @ v - b)) < 1e-6
        assert np.max(np.abs(z * (h - G @ v))) < 1e-6
        assert np.all(z > -1e-9)

        ref = _jax_qp(*(jnp.array(a) for a in qp))
        assert bool(ref.converged)
        np.testing.assert_allclose(v, np.asarray(ref.v), atol=1e-7)
        assert abs(float(res.obj) - float(ref.obj)) <= \
            1e-9 * max(1.0, abs(float(ref.obj)))


def test_box_projection_closed_form():
    s, n = 2.0, 6
    c = np.array([3.0, -1.0, 0.5, -4.0, 0.25, 2.5])
    G = np.vstack([np.eye(n), -np.eye(n)])
    res = solve_qp(t(s * np.eye(n)), t(c),
                   torch.zeros((0, n), dtype=torch.float64),
                   torch.zeros(0, dtype=torch.float64), t(G),
                   t(np.ones(2 * n)))
    np.testing.assert_allclose(res.v.numpy(), np.clip(-c / s, -1, 1),
                               atol=1e-6)


def test_masked_rows():
    n = 3
    c = np.array([1.0, -2.0, 0.5])
    G = np.vstack([np.eye(n), 100 * np.ones((2, n))])
    h = np.concatenate([np.ones(n), np.zeros(2)])
    mask = np.array([True] * n + [False] * 2)
    res = solve_qp(t(2.0 * np.eye(n)), t(c),
                   torch.zeros((0, n), dtype=torch.float64),
                   torch.zeros(0, dtype=torch.float64), t(G), t(h),
                   ineq_mask=t(mask))
    np.testing.assert_allclose(res.v.numpy(), np.clip(-c / 2.0, -np.inf, 1.0),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
def test_master_matches_jax_after_10_steps(name):
    js = jax_solver(name, MAX_ITER=64)
    states, _ = jax_states(js, 10)
    st = states[-1]
    pa = stage_problem(port_problem(name), CPU)
    out = build_and_solve_master(pa, to_port_state(st), st_k := int(st.k))
    ref = jax.jit(jax_master)(js.pa, st, jnp.int32(st_k))
    assert out.ok and bool(ref.ok)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-7)
    assert abs(float(out.eta) - float(ref.eta)) <= \
        1e-7 * max(1.0, abs(float(ref.eta)))
    assert abs(float(out.d_norm2) - float(ref.d_norm2)) <= \
        1e-7 * max(1.0, abs(float(ref.d_norm2)))
    assert abs(float(out.obj) - float(ref.obj)) <= \
        1e-9 * max(1.0, abs(float(ref.obj)))
