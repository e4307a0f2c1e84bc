"""Checkpoint and resume of one replication (``utils/checkpoint.py``).

- A replication resumed from one of its checkpoints returns what the
  uninterrupted one returns in every field but the times, exactly: lands at
  batch 1, and at SAMPLE_INCREMENT 4 with CHECK_EVERY 4, where k strides by
  16 and the checkpoints fire on elapsed k (the JAX package's
  tests/test_io_cli.py:194-213); the bootstrap's resampling draws after
  the checkpoint are the uninterrupted run's.
- A resume after a feasibility round on feastest keeps the feasibility cut
  pool, and returns the uninterrupted result exactly.
- Loading raises on a missing field, on a shape that differs from the fresh
  state's and on generator states of another kind of device; a loaded
  state has the fresh state's Python types and tensor dtypes.
- A checkpoint written by the JAX package loads into the port: one port
  step from it, on the JAX step's injected draw, equals one JAX step from
  the same checkpoint to 1e-9 relative (counts exact).
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch import runner
from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import init_state
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_torch.utils.checkpoint import (
    load_checkpoint, load_state, save_state,
)
from stochasticdecomposition_tpu.utils.checkpoint import (
    save_state as jax_save_state,
)
from torch_common import jax_init, jax_solver, jax_step_draw, port_problem

SMALL = dict(MAX_OMEGA=128, MAX_LAMBDA=512, MAX_SIGMA=512)
TOL = 1e-9


def _solver(name, **cfg):
    return SDSolver(port_problem(name),
                    SDConfig(EVAL_FLAG=False, **SMALL, **cfg), device="cpu")


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def _assert_same_result(a, b):
    for f in dataclasses.fields(a):
        if not f.name.startswith("time_"):
            assert _same(getattr(a, f.name), getattr(b, f.name)), f.name


def _ckpt_ks(directory):
    return [int(p[-10:-4]) for p in
            sorted(glob.glob(os.path.join(directory, "rep00_k*.npz")))]


def _recording_draws(monkeypatch):
    """The bootstrap's resampling draws of each full test, by k."""
    seen = []
    draws = runner.bootstrap_draws

    def recorded(state, gen, reps):
        d = draws(state, gen, reps)
        seen.append((state.k, d.clone()))
        return d

    monkeypatch.setattr(runner, "bootstrap_draws", recorded)
    return seen


@pytest.mark.parametrize("batch", [1, 4])
def test_resume_is_bit_identical(tmp_path, batch, monkeypatch):
    every = 50
    cfg = dict(MAX_ITER=400) if batch == 1 else \
        dict(MAX_ITER=400, SAMPLE_INCREMENT=batch, CHECK_EVERY=4)
    solver = _solver("lands", **cfg)
    draws = _recording_draws(monkeypatch)
    whole = solver.solve_replication(0, checkpoint_every=every,
                                     checkpoint_dir=str(tmp_path))
    whole_draws = list(draws)
    ks = _ckpt_ks(tmp_path)
    # Elapsed k: a save whenever k has advanced by `every` since the last.
    stride = 1 if batch == 1 else 4 * batch
    want, last = [], 0
    for k in range(stride, whole.iterations + 1, stride):
        if k - last >= every:
            want.append(k)
            last = k
    assert ks == want and len(ks) >= 4
    for k in (ks[1], ks[-2]):
        draws.clear()
        resumed = solver.solve_replication(
            0, resume_from=str(tmp_path / f"rep00_k{k:06d}.npz"))
        _assert_same_result(whole, resumed)
        # The bootstrap generator continues too: the same resampling.
        after = [(kk, d) for kk, d in whole_draws if kk >= k]
        assert len(draws) == len(after)
        for (ka, da), (kb, db) in zip(draws, after):
            assert ka == kb and torch.equal(da, db)
    if batch > 1:
        # Full tests ran (and failed) before the checkpoint and after it,
        # so the resumed run continues a generator already advanced.
        assert any(k < ks[-2] for k, _ in whole_draws)
        assert any(k >= ks[-2] for k, _ in whole_draws)


def test_resume_after_feasibility_round_keeps_the_pool(tmp_path):
    solver = _solver("feastest", MAX_ITER=60)
    whole = solver.solve_replication(0, checkpoint_every=10,
                                     checkpoint_dir=str(tmp_path))
    assert whole.feas_rounds > 0
    like = init_state(solver.pa, solver.caps, solver.cfg, solver.mean_sol)
    path = str(tmp_path / f"rep00_k{_ckpt_ks(tmp_path)[0]:06d}.npz")
    state, extras = load_checkpoint(path, like)
    assert state.feas_cnt > 0 and len(extras["pool_alpha"]) > 0
    assert len(extras["pool_beta"]) == len(extras["pool_alpha"])
    _assert_same_result(whole,
                        solver.solve_replication(0, resume_from=path))


def test_load_checks_fields_shapes_and_device(tmp_path):
    solver = _solver("lands", MAX_ITER=40)
    solver.solve_replication(0, checkpoint_every=10,
                             checkpoint_dir=str(tmp_path))
    path = str(tmp_path / "rep00_k000020.npz")
    like = init_state(solver.pa, solver.caps, solver.cfg, solver.mean_sol)
    state = load_state(path, like)
    for f in like._fields:
        a, b = getattr(state, f), getattr(like, f)
        assert type(a) is type(b), f
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f
    assert state.k == 20 and isinstance(state.f_updt, tuple)
    assert state.lane_iters is None

    data = dict(np.load(path))
    # The pools are saved as their filled prefixes, not at capacity.
    assert data["delta_pib"].shape[0] <= state.lambda_cnt
    assert state.lambda_cnt < like.delta_pib.shape[0]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **{k: v for k, v in data.items() if k != "quad_scalar"})
    with pytest.raises(ValueError, match="quad_scalar"):
        load_state(bad, like)
    # A shape that differs, as the file records it, and as a whole array
    # (the JAX package's format, no recorded shape).
    np.savez(bad, **{**data, "__host_shape_cut_beta":
                     data["__host_shape_cut_beta"] - [1, 0]})
    with pytest.raises(ValueError, match="cut_beta has shape"):
        load_state(bad, like)
    np.savez(bad, **{**{k: v for k, v in data.items()
                        if k != "__host_shape_cut_beta"},
                     "cut_beta": like.cut_beta.numpy()[:-1]})
    with pytest.raises(ValueError, match="cut_beta has shape"):
        load_state(bad, like)
    np.savez(bad, **{**data, "__host_device_type": np.asarray("cuda")})
    with pytest.raises(ValueError, match="cuda generator states"):
        solver.solve_replication(0, resume_from=bad)

    # Written and read back: the same state, field for field.
    again = str(tmp_path / "again.npz")
    save_state(again, state)
    back = load_state(again, like)
    for f in like._fields:
        a, b = getattr(state, f), getattr(back, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_jax_checkpoint_steps_like_jax(tmp_path):
    js = jax_solver("lands", MAX_ITER=40, **SMALL)
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                  jax.random.PRNGKey(2))
    for _ in range(12):
        st = js.step(st)
    path = str(tmp_path / "jax.npz")
    jax_save_state(path, st, eval_key=jax.random.PRNGKey(5))
    w = jax_step_draw(js, st)
    jst = js.step(st)

    solver = _solver("lands", MAX_ITER=40)
    like = init_state(solver.pa, solver.caps, solver.cfg, solver.mean_sol)
    ps, extras = load_checkpoint(path, like)
    assert "generators" not in extras and ps.k == 12
    assert ps.cut_cnt == 0 and ps.lane_iters is None
    ps = solver.step(ps, None, torch.as_tensor(w))
    for f in ("candid_x", "incumb_x", "candid_est", "incumb_est",
              "quad_scalar", "cut_alpha", "cut_beta", "sigma_pib",
              "delta_pib"):
        a = getattr(ps, f).numpy()
        b = np.asarray(getattr(jst, f))
        assert np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                      initial=0.0) <= TOL, f
    for f in ("k", "omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt",
              "i_cut_updt"):
        assert getattr(ps, f) == int(getattr(jst, f)), f
    np.testing.assert_array_equal(ps.cut_mask.numpy(),
                                  np.asarray(jst.cut_mask))
