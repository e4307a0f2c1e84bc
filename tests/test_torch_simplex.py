"""The port's solve_lp against the JAX package's solve_lp and against
scipy's HiGHS, on the cases of tests/test_simplex.py plus the warm-started
subproblems of lands and pgp2like.

Tolerances: status exact; objectives 1e-9 relative against JAX (the same
pivot rule on the same data), 1e-6 relative against HiGHS (another
algorithm); primal and duals 1e-8 against JAX, where the optimal basis is
the same; pivot counts exact against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from stochasticdecomposition_torch.core.update import (
    solve_subproblem, subproblem_rhs_cost,
)
from stochasticdecomposition_torch.core.state import stage_problem
from stochasticdecomposition_torch.models.extensive import enumerate_scenarios
from stochasticdecomposition_torch.ops.simplex import (
    AT_LOWER, AT_UPPER, BASIC, STATUS_INFEASIBLE, STATUS_OPTIMAL,
    STATUS_UNBOUNDED, lane, solve_lp,
)
from stochasticdecomposition_tpu.core.update import (
    solve_subproblem as jax_solve_subproblem,
)
from stochasticdecomposition_tpu.ops.simplex import solve_lp as jax_solve_lp
from torch_common import CPU, jax_solver, port_problem

OBJ_RTOL = 1e-9


def _scipy(D, sense, d, l, u, b):
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(len(b)):
        if sense[i] == -1:
            A_ub.append(D[i]); b_ub.append(b[i])
        elif sense[i] == 1:
            A_ub.append(-D[i]); b_ub.append(-b[i])
        else:
            A_eq.append(D[i]); b_eq.append(b[i])
    return linprog(
        d, A_ub=np.array(A_ub) if A_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        A_eq=np.array(A_eq) if A_eq else None,
        b_eq=np.array(b_eq) if b_eq else None,
        bounds=list(zip(l, u)), method="highs")


def _random_lp(rng):
    m = int(rng.integers(3, 12))
    n = int(rng.integers(3, 15))
    D = rng.normal(size=(m, n)).round(2)
    sense = rng.choice([-1, 0, 1], size=m, p=[0.4, 0.2, 0.4])
    d = rng.normal(size=n).round(2)
    b = rng.normal(size=m).round(2)
    l = np.zeros(n)
    u = np.full(n, np.inf)
    ub_mask = rng.random(n) < 0.3
    u[ub_mask] = rng.uniform(0.5, 5.0, size=int(ub_mask.sum()))
    fr_mask = (rng.random(n) < 0.15) & ~ub_mask
    l[fr_mask] = -np.inf
    return D, sense, d, l, u, b


def _port(D, sense, d, l, u, b, **kw):
    t = torch.as_tensor
    return lane(solve_lp(t(D), t(np.asarray(sense, np.int64)), t(d)[None],
                         t(l), t(u), t(b)[None], **kw), 0)


def _jax(D, sense, d, l, u, b, **kw):
    return jax_solve_lp(jnp.array(D), jnp.array(sense), jnp.array(d),
                        jnp.array(l), jnp.array(u), jnp.array(b), **kw)


# The JAX package's partial-pricing cases (tests/test_simplex.py:74-85):
# a small window and candidate list force many full pricings and idle
# pivots.
PP = dict(partial_pricing=True, pp_window=3, pp_cands=4)


@pytest.mark.parametrize("seed", range(4))
def test_partial_pricing_matches_jax(seed):
    """Candidate-list Devex: the JAX package's statuses and pivot counts on
    the same LPs, objectives within 1e-9, and the full-pricing optimum."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        lp = _random_lp(rng)
        out, ref = _port(*lp, **PP), _jax(*lp, **PP)
        assert int(out.status) == int(ref.status)
        assert int(out.iters) == int(ref.iters)
        if int(ref.status) == STATUS_OPTIMAL:
            assert _close(float(out.obj), float(ref.obj), OBJ_RTOL)
            assert _close(float(out.obj), float(_port(*lp).obj), OBJ_RTOL)
            D, d = lp[0], lp[2]
            resid = d - out.pi.numpy() @ D - out.dj.numpy()
            assert np.max(np.abs(resid)) < 1e-7


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(1.0, abs(b))


@pytest.mark.parametrize("seed", range(6))
def test_random_lps_match_highs(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        D, sense, d, l, u, b = lp = _random_lp(rng)
        ref = _scipy(*lp)
        out = _port(*lp)
        status = int(out.status)
        if ref.status == 0:
            assert status == STATUS_OPTIMAL
            assert _close(float(out.obj), ref.fun, 1e-6)
            pi, dj, y = out.pi.numpy(), out.dj.numpy(), out.y.numpy()
            assert np.max(np.abs(d - pi @ D - dj)) < 1e-7   # stationarity
            assert np.max(np.abs(pi * (D @ y - b))) < 1e-6   # compl. slack
        elif ref.status == 2:
            assert status == STATUS_INFEASIBLE
        elif ref.status == 3:
            assert status == STATUS_UNBOUNDED


@pytest.mark.parametrize("seed", range(3))
def test_random_lps_match_jax(seed):
    rng = np.random.default_rng(50 + seed)
    for _ in range(3):
        lp = _random_lp(rng)
        out, ref = _port(*lp), _jax(*lp)
        assert int(out.status) == int(ref.status)
        assert int(out.iters) == int(ref.iters)
        if int(ref.status) == STATUS_OPTIMAL:
            assert _close(float(out.obj), float(ref.obj), OBJ_RTOL)
            np.testing.assert_array_equal(out.basis.numpy(),
                                          np.asarray(ref.basis))
            np.testing.assert_allclose(out.y.numpy(), np.asarray(ref.y),
                                       rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(out.pi.numpy(), np.asarray(ref.pi),
                                       rtol=1e-8, atol=1e-8)


def test_lanes_solve_like_single_lps():
    """The lane axis: a batch of LPs with one D gives each lane's own
    single-lane result (status, objective, pivots)."""
    rng = np.random.default_rng(7)
    D, sense, d, l, u, b = _random_lp(rng)
    bs = np.stack([b + rng.normal(size=b.shape) * 0.3 for _ in range(5)])
    ds = np.stack([d + rng.normal(size=d.shape) * 0.3 for _ in range(5)])
    t = torch.as_tensor
    res = solve_lp(t(D), t(np.asarray(sense, np.int64)), t(ds), t(l), t(u),
                   t(bs))
    for i in range(5):
        one = _port(D, sense, ds[i], l, u, bs[i])
        assert int(res.status[i]) == int(one.status)
        assert int(res.iters[i]) == int(one.iters)
        if int(one.status) == STATUS_OPTIMAL:
            assert _close(float(res.obj[i]), float(one.obj), 1e-12)


LANE_COUNTS = (1, 2, 16, 64)


def _lands_master_lp():
    """The first master LP of lands' LP master (MASTER_TYPE 0) from the
    JAX package's PRNGKey(3) state, 16 x 5 (tests/test_torch_masters.py):
    its cost row equals its second constraint row, so its Devex pricing
    ties exactly and the last bit of a pricing product picks the column."""
    import jax

    from stochasticdecomposition_torch.config import MASTER_LP
    from stochasticdecomposition_torch.core.master import master_lp_data
    from torch_common import jax_init, to_port_state

    js = jax_solver("lands", MAX_ITER=64, MASTER_TYPE=MASTER_LP)
    pa = stage_problem(port_problem("lands"), CPU)
    ps = to_port_state(jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                                jax.random.PRNGKey(3)))
    D, sense, c, lo, hi, b = master_lp_data(pa, ps, ps.k + 1)
    return D.numpy(), sense.numpy(), c.numpy(), lo.numpy(), hi.numpy(), \
        b.numpy()


@pytest.mark.parametrize("case", ["lands_master", "random_1", "random_2"])
def test_a_lane_does_not_depend_on_the_lane_count(case):
    """Lane 0 of an LP solved alone and among 1, 15 and 63 copies: the
    same pivots, basis and bits in every field.  On the lands master LP
    the JAX package takes 5 pivots; so does every width here."""
    if case == "lands_master":
        lp = _lands_master_lp()
    else:
        lp = _random_lp(np.random.default_rng(int(case[-1])))
    D, sense, d, l, u, b = (torch.as_tensor(np.asarray(a)) for a in lp)
    sense = sense.to(torch.int64)
    lanes = []
    for W in LANE_COUNTS:
        res = solve_lp(D, sense, d[None].expand(W, -1), l, u,
                       b[None].expand(W, -1))
        lanes.append(lane(res, 0))
    for W, got in zip(LANE_COUNTS[1:], lanes[1:]):
        for f, a, g in zip(lanes[0]._fields, lanes[0], got):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(g)), \
                (W, f)
    if case == "lands_master":
        assert int(lanes[0].iters) == int(_jax(*lp).iters) == 5


def test_dual_sign_convention():
    inf = np.inf
    out = _port([[1.0]], [-1], [-1.0], [0.0], [inf], [2.0])
    assert int(out.status) == STATUS_OPTIMAL
    assert float(out.y[0]) == pytest.approx(2.0)
    assert float(out.pi[0]) == pytest.approx(-1.0)
    out = _port([[1.0]], [1], [1.0], [0.0], [inf], [3.0])
    assert float(out.pi[0]) == pytest.approx(1.0)


def test_cstat_and_basis():
    out = _port(np.array([[1.0, 1.0], [0.0, 1.0]]), [-1, -1], [-1.0, -2.0],
                [0.0, 0.0], [10.0, 10.0], [4.0, 3.0])
    assert int(out.status) == STATUS_OPTIMAL
    np.testing.assert_allclose(out.y.numpy(), [1.0, 3.0], atol=1e-9)
    assert set(int(s) for s in out.cstat) <= {AT_LOWER, BASIC, AT_UPPER}


def test_farkas_certificate():
    # y1 + y2 >= 5 and y1 + y2 <= 3 with y >= 0: infeasible.
    D = np.array([[1.0, 1.0], [1.0, 1.0]])
    out = _port(D, [1, -1], [1.0, 1.0], [0.0, 0.0], [np.inf, np.inf],
                [5.0, 3.0])
    assert int(out.status) == STATUS_INFEASIBLE
    ray = out.farkas.numpy()
    # ray'D <= 0 on the nonnegative columns and ray'b > 0.
    assert np.all(ray @ D <= 1e-9)
    assert ray @ np.array([5.0, 3.0]) > 1e-9


def test_pivot_dtype_and_lite_options():
    """pivot_dtype is accepted and solved in f64 (the same result), and lite
    gives the full solve's status and objective."""
    lp = _random_lp(np.random.default_rng(1))
    full = _port(*lp)
    f32 = _port(*lp, pivot_dtype=torch.float32)
    for a, b in zip(full, f32):
        assert torch.equal(a, b)
    lite = _port(*lp, lite=True)
    assert int(lite.status) == int(full.status)
    assert abs(float(lite.obj) - float(full.obj)) <= \
        1e-9 * max(1.0, abs(float(full.obj)))


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
def test_warm_started_subproblems_match_jax_and_highs(name):
    """Subproblems at the mean-value solution under random scenarios, cold
    and then warm-started from the previous optimal basis, as the SD step
    solves them."""
    js = jax_solver(name, MAX_ITER=64)
    sp = port_problem(name)
    pa = stage_problem(sp, CPU)
    x = torch.as_tensor(np.array(js.mean_sol))
    outs, _ = enumerate_scenarios(sp._stoc, sp.rv_order)
    W = outs - pa.omega_mean.numpy()[None]
    rng = np.random.default_rng(3)
    basis = atup = None
    jbasis = jatup = None
    for i in range(4):
        w = W[rng.integers(len(W))]
        out = solve_subproblem(pa, x, torch.as_tensor(w), init_basis=basis,
                               init_at_upper=atup)
        ref = jax_solve_subproblem(js.pa, jnp.asarray(np.asarray(x)),
                                   jnp.asarray(w), init_basis=jbasis,
                                   init_at_upper=jatup)
        assert int(out.status) == int(ref.status) == STATUS_OPTIMAL
        assert int(out.iters) == int(ref.iters)
        assert _close(float(out.obj), float(ref.obj), OBJ_RTOL)
        np.testing.assert_allclose(out.pi.numpy(), np.asarray(ref.pi),
                                   rtol=1e-8, atol=1e-8)
        rhs, cost = subproblem_rhs_cost(pa, x, torch.as_tensor(w))
        hi = _scipy(pa.D.numpy(), pa.sense2.numpy(), cost.numpy(),
                    pa.l2.numpy(), pa.u2.numpy(), rhs.numpy())
        assert hi.status == 0 and _close(float(out.obj), hi.fun, 1e-6)
        basis = out.basis
        atup = torch.cat([out.cstat, out.rstat]) == AT_UPPER
        jbasis = ref.basis
        jatup = jnp.concatenate([ref.cstat, ref.rstat]) == AT_UPPER
