"""Batched sampling (SAMPLE_INCREMENT > 1) and CHECK_EVERY: the port against
the JAX package, and against itself.

- SD steps at B = 4 and 16 on lands and B = 4 on pgp2like, and two steps
  at B = 4 at the suite's 4nodelike width (74 x 186), with the JAX
  package's draws injected: iterates, estimates and the ratio window to 1e-7
  relative, pool counts, cut counts, LP counts and the warm basis exact.
  SCAN_LEN is small (32 samples: a window of 8 steps) so that the window
  wraps and the variance gate, which counts samples, opens inside the run.
- The batched dedup and pooling equal B sequential ``calc_omega`` +
  ``stochastic_updates`` calls exactly (pools, slot order, weights, delta
  tables), and the JAX package's ``stochastic_updates_batch`` to 1e-12.
- CHECK_EVERY = 4 equals four single steps on the same generator (exact),
  and the JAX package's chunked step on its draws (1e-7).
- SUBPROB_F32_PIVOT and SUBPROB_STAGED_BATCH change nothing in the port
  (exact), and a solve split into passes of ``lane_cap`` lanes equals one
  pass (status and pivots exact, values 1e-12).
- ``SDSolver`` at SAMPLE_INCREMENT 4 and CHECK_EVERY 4 reaches the
  certified stop (exact gap within 0.01), and overflowed batched pools
  warn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import (
    derive_capacities, init_state, stage_problem,
)
from stochasticdecomposition_torch.core.step import make_step
from stochasticdecomposition_torch.core.update import (
    calc_omega, calc_omega_batch, stochastic_updates,
    stochastic_updates_batch, subproblem_rhs_cost_lanes,
)
from stochasticdecomposition_torch.ops.simplex import lane, solve_lp
from stochasticdecomposition_torch.runner import replication_generators
from stochasticdecomposition_torch.sampler import build_sampler
from stochasticdecomposition_tpu.core import update as jupd
from stochasticdecomposition_tpu.core.step import make_step as jax_make_step
from torch_common import CPU, jax_chunk_draws, jax_init, \
    jax_solver, jax_step_draw, port_problem, to_port_state

RTOL = 1e-7
SCAN = 32


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _assert_states_match(ps, st, tag):
    for f in ("candid_x", "incumb_x", "incumb_est", "candid_est",
              "quad_scalar", "pi_ratio", "sigma_pib", "cut_alpha",
              "cut_beta", "delta_pib"):
        assert _rel(getattr(ps, f), getattr(st, f)) <= RTOL, (tag, f)
    for f in ("k", "omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt",
              "i_cut_updt", "ratio_cnt"):
        assert getattr(ps, f) == int(getattr(st, f)), (tag, f)
    assert int(ps.cut_mask.sum()) == int(jnp.sum(st.cut_mask)), tag
    assert ps.dual_stable == bool(st.dual_stable), tag
    np.testing.assert_array_equal(ps.warm_basis.numpy(),
                                  np.asarray(st.warm_basis), err_msg=tag)
    np.testing.assert_array_equal(ps.omega_w.numpy(),
                                  np.asarray(st.omega_w), err_msg=tag)


@pytest.mark.parametrize("name,batch,steps", [
    ("lands", 4, 30), ("lands", 16, 20), ("pgp2like", 4, 20),
    ("4nodelike", 4, 2)])
def test_batched_steps_match_jax(name, batch, steps):
    """The states hold to RTOL (1e-7 relative), counts and the warm basis
    exactly.  4nodelike is the suite's width (second stage 74 x 186, staged
    with 74 surplus columns; 12 RHS RVs) for two steps, too few for the
    window to wrap."""
    kw = dict(MAX_ITER=steps * batch, SAMPLE_INCREMENT=batch, SCAN_LEN=SCAN)
    js = jax_solver(name, **kw)
    pa = stage_problem(port_problem(name), CPU)
    if name == "4nodelike":
        assert pa.D.shape[0] == 74
    cfg = SDConfig(EVAL_FLAG=False, **kw)
    assert cfg.eff_scan_len() == 8
    step = make_step(pa, None, cfg)
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol, jax.random.PRNGKey(3))
    ps = to_port_state(st)
    for i in range(steps):
        w = jax_step_draw(js, st, batch)
        st = js.step(st)
        ps = step(ps, None, torch.as_tensor(w))
        _assert_states_match(ps, st, i)
        assert ps.lane_iters.shape == (batch,)
    assert ps.k == steps * batch and ps.lp_cnt > steps * batch
    if steps > 8:
        # The window wrapped: k passed scan_len * batch samples.
        assert ps.k > 8 * batch and ps.ratio_cnt > 8


@pytest.mark.parametrize("name,batch", [("lands", 16), ("pgp2like", 8)])
def test_batch_pooling_identical_to_sequential(name, batch):
    js = jax_solver(name, MAX_ITER=64, SAMPLE_INCREMENT=batch)
    sp = port_problem(name)
    pa = stage_problem(sp, CPU)
    cfg = SDConfig(MAX_ITER=64, EVAL_FLAG=False, SAMPLE_INCREMENT=batch)
    tol = cfg.TOLERANCE
    caps = derive_capacities(sp, cfg)
    spec = build_sampler(sp._stoc, sp.rv_order, CPU)
    gen, _ = replication_generators(11, CPU)
    st0 = init_state(pa, caps, cfg, np.array(js.mean_sol))
    jst0 = jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                    jax.random.PRNGKey(0))
    from stochasticdecomposition_torch.sampler import sample_omega
    # Two rounds: the first fills empty pools, the second dedups against
    # them.
    for rnd in range(2):
        w = sample_omega(spec, gen, batch) - pa.omega_mean[None]
        k = (rnd + 1) * batch

        def copy(s):
            return s._replace(**{f: v.clone() for f, v in s._asdict().items()
                                 if isinstance(v, torch.Tensor)})

        # (a) sequential: per-observation dedup, then per-dual updates.
        sa = copy(st0)
        oi_a, nf_a = [], []
        for i in range(batch):
            sa, oi, nf = calc_omega(sa, w[i], tol)
            oi_a.append(oi)
            nf_a.append(nf)
        ws = sa.omega_vals[torch.as_tensor(oi_a)]
        rhs, cost = subproblem_rhs_cost_lanes(pa, st0.candid_x, ws)
        res_b = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs,
                         init_basis=st0.warm_basis.expand(batch, -1),
                         init_at_upper=st0.warm_atup.expand(batch, -1))
        for i in range(batch):
            sa, _ = stochastic_updates(pa, sa, lane(res_b, i), oi_a[i],
                                       nf_a[i], k, tol)

        # (b) the batched path.
        sb, oi_b, nf_b = calc_omega_batch(copy(st0), w, tol)
        np.testing.assert_array_equal(oi_b, oi_a)
        np.testing.assert_array_equal(nf_b, nf_a)
        sb = stochastic_updates_batch(pa, sb, res_b, oi_b, nf_b, k, tol)

        # (c) the JAX package's batched path on the same duals.
        jres = jax.tree.map(jnp.asarray, res_b._replace(
            **{f: v.numpy() for f, v in res_b._asdict().items()}))
        jst, joi, jnf = jupd.calc_omega_batch(jst0, jnp.asarray(w.numpy()),
                                              tol)
        jst = jupd.stochastic_updates_batch(
            js.pa, jst, jres, joi, jnf, jnp.int32(k), tol)
        np.testing.assert_array_equal(np.asarray(joi), oi_b)

        for f in ("omega_vals", "omega_w", "omega_cnt", "lambda_vals",
                  "lambda_cnt", "sigma_pib", "sigma_piC", "sigma_lidx",
                  "sigma_ck", "sigma_feas", "sigma_cnt", "delta_pib",
                  "delta_piC"):
            a, b = getattr(sa, f), getattr(sb, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (rnd, f)
            else:
                assert a == b, (rnd, f)
            j = np.asarray(getattr(jst, f))
            if j.dtype.kind == "f":
                assert _rel(b, j) <= 1e-12, (rnd, f)
            else:
                np.testing.assert_array_equal(np.asarray(b), j,
                                              err_msg=f"{rnd} {f}")
        st0 = sb
        jst0 = jst
    assert st0.lambda_cnt > 1 and st0.sigma_cnt > 1


def _fresh(pa, caps, cfg, x0):
    return init_state(pa, caps, cfg, x0)


def test_check_every_equals_single_steps():
    name, batch = "lands", 4
    sp = port_problem(name)
    pa = stage_problem(sp, CPU)
    spec = build_sampler(sp._stoc, sp.rv_order, CPU)
    kw = dict(MAX_ITER=64, EVAL_FLAG=False, SAMPLE_INCREMENT=batch)
    cfg1, cfg4 = SDConfig(**kw), SDConfig(CHECK_EVERY=4, **kw)
    js = jax_solver(name, MAX_ITER=64, SAMPLE_INCREMENT=batch)
    caps = derive_capacities(sp, cfg1)
    x0 = np.array(js.mean_sol)
    step1, step4 = make_step(pa, spec, cfg1), make_step(pa, spec, cfg4)
    s1, s4 = _fresh(pa, caps, cfg1, x0), _fresh(pa, caps, cfg4, x0)
    g1, _ = replication_generators(5, CPU)
    g4, _ = replication_generators(5, CPU)
    for _ in range(8):
        s1 = step1(s1, g1)
    for _ in range(2):
        s4 = step4(s4, g4)
    assert s1.k == s4.k == 8 * batch
    for f, a in s1._asdict().items():
        b = getattr(s4, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f

    # Against the JAX package's chunked step (a scan of 4 steps).
    from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
    jcfg = JaxConfig(CHECK_EVERY=4, **kw)
    jstep4 = jax_make_step(js.pa, js.spec, jcfg)
    st = jax_init(js.pa, js.caps, jcfg, js.mean_sol, jax.random.PRNGKey(2))
    ps = to_port_state(st)
    for i in range(2):
        w = jax_chunk_draws(js, st, 4, batch)
        st = jstep4(st)
        ps = step4(ps, None, torch.as_tensor(w))
        _assert_states_match(ps, st, i)


def test_f32_pivot_and_staging_keys_change_nothing():
    sp = port_problem("lands")
    pa = stage_problem(sp, CPU)
    spec = build_sampler(sp._stoc, sp.rv_order, CPU)
    kw = dict(MAX_ITER=96, EVAL_FLAG=False, SAMPLE_INCREMENT=24)
    cfg_a = SDConfig(**kw)
    cfg_b = SDConfig(SUBPROB_F32_PIVOT=True, SUBPROB_STAGED_BATCH=True,
                     EVAL_F32_PIVOT=True, **kw)
    caps = derive_capacities(sp, cfg_a)
    x0 = np.zeros(pa.c1.shape[0])
    out = []
    for cfg in (cfg_a, cfg_b):
        step = make_step(pa, spec, cfg)
        s = _fresh(pa, caps, cfg, x0)
        gen, _ = replication_generators(9, CPU)
        for _ in range(3):
            s = step(s, gen)
        out.append(s)
    for f, a in out[0]._asdict().items():
        b = getattr(out[1], f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f


def test_lane_passes_match_one_pass(monkeypatch):
    from stochasticdecomposition_torch.ops import simplex

    js = jax_solver("pgp2like", MAX_ITER=64)
    pa = stage_problem(port_problem("pgp2like"), CPU)
    rng = np.random.default_rng(4)
    W = torch.as_tensor(rng.normal(0.0, 1.0, (11, pa.omega_mean.shape[0])))
    x = torch.as_tensor(np.array(js.mean_sol))
    rhs, cost = subproblem_rhs_cost_lanes(pa, x, W)
    one = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs)
    monkeypatch.setattr(simplex, "lane_cap", lambda m, n, device: 3)
    split = solve_lp(pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs)
    for f in ("status", "iters", "basis", "cstat", "rstat"):
        assert torch.equal(getattr(one, f), getattr(split, f)), f
    for f in ("obj", "y", "pi", "dj"):
        assert _rel(getattr(split, f), getattr(one, f)) <= 1e-12, f


def test_unported_configurations_raise():
    """Several replications and the compromise problem, which the port
    refused before ROADMAP A15, now run: ``SDSolver.run`` returns every
    replication and, with COMPROMISE_PROB, the compromise and average
    decisions.  What the port still refuses is a run over several cards
    (ROADMAP A17): the CLI's ``--mesh``."""
    from stochasticdecomposition_torch import cli
    from stochasticdecomposition_torch.config import MASTER_LP
    from stochasticdecomposition_torch.runner import RunResult, SDSolver

    pa = stage_problem(port_problem("lands"), CPU)
    make_step(pa, None, SDConfig(MASTER_TYPE=MASTER_LP, EVAL_FLAG=False))
    for kw in (dict(MULTIPLE_REP=2),
               dict(MULTIPLE_REP=2, COMPROMISE_PROB=True)):
        solver = SDSolver(port_problem("lands"),
                          SDConfig(MAX_ITER=16, EVAL_FLAG=False, **kw),
                          device="cpu")
        result = solver.run()
        assert isinstance(result, RunResult)
        assert [r.rep for r in result.replications] == [0, 1]
        assert all(r.iterations == 16 for r in result.replications)
        if kw.get("COMPROMISE_PROB"):
            assert result.compromise_x.shape == (4,)
            np.testing.assert_array_equal(
                result.average_x, np.mean([r.incumb_x for r in
                                           result.replications], axis=0))
        else:
            assert result.compromise_x is None
    assert cli.main(["-p", "lands", "--mesh", "2x1", "--device",
                     "cpu"]) == 2


def test_batched_replication_stops_and_flags_overflow():
    """SDSolver at SAMPLE_INCREMENT 4 and CHECK_EVERY 4: k strides by 16
    between host gates, the certified stop is reached with the exact gap
    within 0.01, and overflowed dual-vertex pools warn (the batched
    pooling drops the entries past capacity)."""
    from stochasticdecomposition_torch.models.extensive import (
        enumerate_scenarios, exact_objective_fn,
    )
    from stochasticdecomposition_torch.runner import SDSolver

    sp = port_problem("lands")
    solver = SDSolver(sp, SDConfig(MAX_ITER=2048, EVAL_FLAG=False,
                                   SAMPLE_INCREMENT=4, CHECK_EVERY=4,
                                   MAX_OMEGA=128, MAX_LAMBDA=512,
                                   MAX_SIGMA=512), device="cpu")
    res = solver.solve_replication(0)
    assert res.optimal and res.iterations % 16 == 0
    assert res.lp_count >= res.iterations
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    exact = exact_objective_fn(solver.pa, outs, probs)(res.incumb_x)
    assert abs(exact - 382.0222) / 382.0222 <= 0.01

    small = SDSolver(sp, SDConfig(MAX_ITER=64, EVAL_FLAG=False,
                                  SAMPLE_INCREMENT=8, MAX_LAMBDA=1,
                                  MAX_SIGMA=1), device="cpu")
    with pytest.warns(RuntimeWarning, match="dual-vertex pools"):
        r = small.solve_replication(0)
    assert r.pool_sizes["lam"] > 1 and r.iterations == 64
