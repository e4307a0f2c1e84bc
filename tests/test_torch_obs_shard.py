"""One replication's pools sharded over the obs ranks of a mesh.

``tests/torch_obs_worker.py`` runs as four processes joined by
``torch.distributed`` over ``gloo`` (a ``file://`` store under the test's
temporary directory), the CPU emulation of four cards; each rank keeps only
its block of the observation columns of ``omega_vals``, ``omega_w``,
``delta_pib``, ``delta_piC`` and ``cut_istar``.  Besides ``lands`` and
``pgp2like``, whose few distinct observations all fall in the first block,
the synthetic ``spread`` instance (4^7 scenarios, random RHS and
technology) draws almost only new observations, so that its pools fill
several blocks.  Held against the unsharded port on the same inputs:

  * one cut on a pool the port built (from injected JAX draws), split over
    4 and 2 ranks: iStar concatenated over the ranks equal to the
    unsharded cut's, alpha and beta within 1e-12, the pools after the cut
    equal; and within 1e-9 of the JAX package's ``form_cut`` on the same
    state (the harness of ``tests/test_torch_cuts.py``);
  * runs of the step on injected JAX draws at batch 1 and 8: counts exact,
    iterates and pools within ``tests/test_torch_step.py``'s 1e-7;
  * the bootstrap: the draws from a seeded generator identical, the two
    sides of the gap within 1e-9 on injected resampling draws, the full
    test's verdicts and pass fractions equal over an EPSILON sweep;
  * ``SDSolver.run(mesh=2x2)`` and the CLI over a 2x2 mesh by
    ``tests/test_mesh_runner.py``'s rules (iterations, ``optimal``,
    ``unique_omegas`` and pool sizes exact, incumbents and estimates within
    1e-8, the compromise within 1e-6); the LP master on RUN_SEEDs whose
    candidates do not tie (ROADMAP C);
  * a rank that reports a perturbed lockstep digest makes every rank raise;
  * the obs groups of a mesh shape are built once per process, and the two
    obs ranks of a rep group made as many collectives as each other.

Random costs shard too (``spread_d``: two random cost coefficients;
``obs_feas`` is split like the observation columns): one cut within 1e-9
of the JAX package's, and runs by the same rules.  Checkpoints of a 2x2
run of spread, resumed after observations passed rank 1's first column:
bit-identical over 2x2, within 1e-8 over 2x1.

In one process: the refusal of an O the obs ranks do not divide, a
checkpoint loaded into each obs block, and the per-rank pool bytes.
``tests/test_torch_mesh.py``'s 2x2 runs of ``lands`` and ``feastest``
shard too.  Every process is killed at its timeout.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch import cli
from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import (
    derive_capacities, estimate_pool_bytes, init_state, stage_problem,
)
from stochasticdecomposition_torch.core.stopping import (
    bootstrap_bounds, bootstrap_draws, full_test,
)
from stochasticdecomposition_torch.interop import state_from_numpy
from stochasticdecomposition_torch.parallel.distributed import ObsShard
from stochasticdecomposition_torch.parallel.mesh import Mesh
from stochasticdecomposition_torch.parallel.runner import (
    run_replications_meshed,
)
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.core import cuts as jcuts
from stochasticdecomposition_tpu.core import update as jupd
import torch_obs_worker as worker
from torch_common import CPU, jax_chunk_draws, jax_init, jax_solver, \
    port_problem, synthetic_spec

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 240
WORLD = 4
TOL = 1e-3                      # SDConfig.TOLERANCE
RTOL = 1e-7                     # tests/test_torch_step.py
EPSILONS = [1e-3, 3e-2, 1e-1, 1.0]
BOOT_REPS = 50
BOOT_SEED = 11


def _spec(name, tag=None, **cfg):
    return {"name": name, "tag": tag or name, "synthetic": synthetic_spec(name),
            "cfg": {"EVAL_FLAG": False, **cfg}}


# (name, steps, batch, MAX_ITER); the bootstrap on the batch-1 runs.
STEP_JOBS = [("lands", 30, 1, 64), ("spread", 90, 1, 120),
             ("pgp2like", 30, 1, 64), ("pgp2like", 8, 8, 64),
             ("spread", 12, 8, 120)]
# (tag, name, steps, MAX_ITER, the stored observation drawn again or None
# for the next draw): a match in rank 0's columns (lands), a new
# observation, and a match in the columns past 64 (obs rank 1 of 2, 2 of 4).
CUT_CASES = [("lands", "lands", 20, 64, None),
             ("spread", "spread", 70, 120, None),
             ("spread_match", "spread", 70, 120, 66),
             ("spread_d", "spread_d", 70, 120, None)]
RUNS = [
    _spec("spread", MAX_ITER=100, MULTIPLE_REP=2, COMPROMISE_PROB=True),
    _spec("pgp2like", MAX_ITER=60, MULTIPLE_REP=2),
    _spec("pgp2like", "pgp2like_b8", MAX_ITER=96, SAMPLE_INCREMENT=8,
          MULTIPLE_REP=2),
    # RUN_SEED entries 2 and 3: candidates without tied dual vertices.
    _spec("lands", "lands_lp", MAX_ITER=40, MULTIPLE_REP=2, MASTER_TYPE=0,
          RUN_SEED=SDConfig().RUN_SEED[2:]),
    # Random costs: obs_feas and the basis pool's sums over the ranks.
    _spec("spread_d", MAX_ITER=300, MULTIPLE_REP=2),
]
# Checkpoints of a sharded run, resumed over 2x2 and 2x1: at MAX_ITER 300
# (O = 384) spread's observations pass rank 1's first column (192) before
# the second checkpoint, at k = 2 * RESUME_EVERY.
RESUME_EVERY = 100
RESUME = {**_spec("spread", "spread_resume", MAX_ITER=300, MULTIPLE_REP=2),
          "every": RESUME_EVERY}
CLI_RUN = ["-p", "lands", "-m", "2", "-c", "1", "--max-iter", "30", "-e",
           "0", "--device", "cpu"]


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0.0)


def _job_tag(name, steps, batch):
    return f"{name}_b{batch}_{steps}"


@functools.lru_cache(maxsize=None)
def _draws(name, steps, batch, max_iter):
    """The JAX package and its draws of ``steps`` steps from PRNGKey(1):
    [steps, R] at batch 1, else [steps, B, R]."""
    js = jax_solver(name, MAX_ITER=max_iter, SAMPLE_INCREMENT=batch)
    draws = jax_chunk_draws(js, jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                                         jax.random.PRNGKey(1)), steps, batch)
    return js, draws[:, 0] if batch == 1 else draws


@functools.lru_cache(maxsize=None)
def _port_steps(name, steps, batch, max_iter):
    """The unsharded port's solver and its state after ``steps`` steps on
    ``_draws``."""
    solver = SDSolver(port_problem(name), SDConfig(
        MAX_ITER=max_iter, SAMPLE_INCREMENT=batch, EVAL_FLAG=False),
        device="cpu")
    state = init_state(solver.pa, solver.caps, solver.cfg, solver.mean_sol)
    for w in _draws(name, steps, batch, max_iter)[1]:
        state = solver.step(state, None, torch.as_tensor(w))
    return solver, state


def _numpy_fields(state):
    return {f: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for f, v in state._asdict().items()
            if f not in ("shard", "lane_iters")}


def _boot_draws(state):
    p = state.omega_w.numpy().astype(float)
    rng = np.random.default_rng(BOOT_SEED)
    return rng.choice(p.shape[0], size=(BOOT_REPS, state.k), p=p / p.sum())


def _launch(tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
        env.get("PYTHONPATH", "")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
                 "PROCESS_ID"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_obs_worker.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


@pytest.fixture(scope="module")
def obs_run(tmp_path_factory):
    """Writes the plan and its inputs, runs the four ranks; returns each
    rank's (json, arrays)."""
    tmp = tmp_path_factory.mktemp("obs")
    plan = {"cuts": [], "steps": [], "runs": RUNS, "epsilons": EPSILONS,
            "boot_seed": BOOT_SEED, "boot_reps": BOOT_REPS,
            "cli": CLI_RUN + ["--mesh", "2x2", "--distributed"],
            "lockstep": _spec("lands", MAX_ITER=20), "resume": RESUME}
    for tag, name, k, max_iter, again in CUT_CASES:
        solver, state = _port_steps(name, k, 1, max_iter)
        fields = _numpy_fields(state)
        fields["__w"] = state.omega_vals[again].numpy() if again is not None \
            else _draws(name, k + 1, 1, max_iter)[1][k] - \
            solver.pa.omega_mean.numpy()
        fields["__k"] = np.asarray(k + 1)
        np.savez(tmp / f"{tag}.npz", **fields)
        plan["cuts"].append({**_spec(name, tag, MAX_ITER=max_iter),
                             "tol": TOL})
    for name, steps, batch, max_iter in STEP_JOBS:
        tag = _job_tag(name, steps, batch)
        _, state = _port_steps(name, steps, batch, max_iter)
        np.save(tmp / f"{tag}_draws.npy",
                _draws(name, steps, batch, max_iter)[1])
        job = _spec(name, tag, MAX_ITER=max_iter, SAMPLE_INCREMENT=batch)
        if _boots(name, batch):
            job["boot"] = True
            np.save(tmp / f"{tag}_boot.npy", _boot_draws(state))
        plan["steps"].append(job)
    with open(tmp / "plan.json", "w") as fh:
        json.dump(plan, fh)
    for r, (rc, out, err) in enumerate(_launch(tmp)):
        assert rc == 0, f"rank {r} failed:\n{out[-2000:]}\n{err[-4000:]}"
    return tmp, [(json.load(open(tmp / f"rank{r}.json")),
                  dict(np.load(tmp / f"rank{r}.npz"))) for r in range(WORLD)]


def _boots(name, batch):
    """Whether a step job also holds the bootstrap."""
    return batch == 1 and name != "pgp2like"


SHAPES = {"1x4": (1, 4), "2x2": (2, 2)}
OBS_AXIS = {"omega_vals": 0, "omega_w": 0, "delta_pib": 1, "delta_piC": 1,
            "cut_istar": 1}


def _joined(arrays, key, axis):
    """One field's obs blocks, from the ranks' arrays in obs order."""
    return np.concatenate([a[key] for a in arrays], axis=axis)


def _jax_cut(js, fields, w, k):
    """The JAX package's cut on the port state whose ``fields`` are given
    (put into a JAX state): tests/test_torch_cuts.py's harness."""
    jst = jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                   jax.random.PRNGKey(0))
    jst = jst._replace(**{f: jnp.asarray(fields[f],
                                         dtype=jnp.asarray(getattr(jst, f)).dtype)
                          for f in jst._fields if f in fields})

    def one(pa, st, w, k):
        st, o_idx, new_o = jupd.calc_omega(st, w, TOL)
        res, st = jupd.warm_solve_subproblem(pa, st, st.candid_x,
                                             st.omega_vals[o_idx])
        st, _ = jupd.stochastic_updates(pa, st, res, o_idx, new_o, k, TOL)
        parts, st = jcuts.form_cut(pa, st, st.candid_x, k,
                                   dual_stability=True, pi_eval_start=0,
                                   pi_cycle=1, scan_len=256)
        st, slot = jcuts.add_cut(pa, st, parts, k, incumbent=False, tol=TOL)
        return parts, st, slot

    return jax.jit(one)(js.pa, jst, jnp.asarray(w), jnp.int32(k))


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
@pytest.mark.parametrize("case,name,k,max_iter,again", CUT_CASES)
def test_one_cut_split_over_ranks(obs_run, case, name, k, max_iter, again,
                                  shape):
    tmp, ranks = obs_run
    solver, _ = _port_steps(name, k, 1, max_iter)
    with np.load(tmp / f"{case}.npz") as data:
        fields = dict(data)
    w = fields.pop("__w")
    parts, want, slot = worker.one_cut(solver.pa, state_from_numpy(fields),
                                       torch.as_tensor(w), k + 1, TOL)
    feas_alpha, feas_beta = worker.feas_cuts(solver.pa,
                                             state_from_numpy(fields))

    tag = f"cut/{case}/{shape}"
    n_obs = SHAPES[shape][1]
    got = [ranks[r][0][tag] for r in range(n_obs)]    # rep group 0
    arrays = [ranks[r][1] for r in range(n_obs)]
    O = want.omega_w.shape[0]
    assert [(g["lo"], g["hi"]) for g in got] == \
        [(j * O // n_obs, (j + 1) * O // n_obs) for j in range(n_obs)]
    for g, a in zip(got, arrays):
        assert g["slot"] == slot and g["found"] == parts.found
        assert g["obs_shapes"][1] == [O // n_obs]
        for f in worker.COUNTS:
            assert g[f] == getattr(want, f), f
        assert _rel(a[f"{tag}/alpha"], parts.alpha) <= 1e-12
        assert _rel(a[f"{tag}/beta"], parts.beta) <= 1e-12
    np.testing.assert_array_equal(_joined(arrays, f"{tag}/istar", 0),
                                  parts.istar.numpy())
    for f, axis in OBS_AXIS.items():
        assert _rel(_joined(arrays, f"{tag}/{f}", axis),
                    getattr(want, f)) <= 1e-12, f
    if name.startswith("spread"):   # the pool spans more than one block
        assert want.omega_cnt > O // 2
    if name == "spread":             # and so do the rays' cuts
        assert feas_alpha.shape[0] > O // 2
    if pa_randcost(solver):          # obs_feas split like the columns
        np.testing.assert_array_equal(_joined(arrays, f"{tag}/obs_feas", 1),
                                      want.obs_feas.numpy())
        assert want.basis_cnt >= 1
    if again is not None:    # found in another rank's columns, not added
        assert want.omega_cnt == int(fields["omega_cnt"])
        assert int(want.omega_w[again]) == int(fields["omega_w"][again]) + 1
    for a in arrays:         # every rank holds every feasibility cut
        np.testing.assert_array_equal(a[f"{tag}/feas_alpha"], feas_alpha)
        np.testing.assert_array_equal(a[f"{tag}/feas_beta"], feas_beta)

    # The JAX package's cut on the same state.
    jparts, jst, jslot = _jax_cut(_draws(name, k, 1, max_iter)[0], fields,
                                  w, k + 1)
    np.testing.assert_array_equal(_joined(arrays, f"{tag}/istar", 0),
                                  np.asarray(jparts.istar))
    assert _rel(arrays[0][f"{tag}/alpha"], jparts.alpha) <= 1e-9
    assert _rel(arrays[0][f"{tag}/beta"], jparts.beta) <= 1e-9
    assert got[0]["slot"] == int(jslot)
    assert got[0]["sigma_cnt"] == int(jst.sigma_cnt)


@pytest.mark.parametrize("name,steps,batch,max_iter", STEP_JOBS)
def test_steps_match_unsharded(obs_run, name, steps, batch, max_iter):
    _, ranks = obs_run
    solver, want = _port_steps(name, steps, batch, max_iter)
    tag = f"steps/{_job_tag(name, steps, batch)}"
    group = STEP_JOBS.index((name, steps, batch, max_iter)) % 2
    mine = [ranks[2 * group + j] for j in (0, 1)]
    O = want.omega_w.shape[0]
    for j, (out, arrays) in enumerate(mine):
        g = out[tag]
        assert (g["lo"], g["hi"]) == (j * O // 2, (j + 1) * O // 2)
        assert g["obs_shapes"][0] == [O // 2, want.omega_vals.shape[1]]
        for f in worker.COUNTS:
            assert g[f] == getattr(want, f), f
        for f in worker.REPLICATED:
            assert _rel(arrays[f"{tag}/{f}"], getattr(want, f)) <= RTOL, f
    arrays = [a for _, a in mine]
    for f, axis in OBS_AXIS.items():
        got = _joined(arrays, f"{tag}/{f}", axis)
        if f in ("omega_w", "cut_istar"):
            np.testing.assert_array_equal(got, getattr(want, f).numpy(), f)
        else:
            assert _rel(got, getattr(want, f)) <= RTOL, f
    if name == "spread":
        assert want.omega_cnt > O // 2
    if _boots(name, batch):
        _bootstrap_matches(mine, tag, solver, want)


def _bootstrap_matches(mine, tag, solver, want):
    draws = bootstrap_draws(want, torch.Generator().manual_seed(BOOT_SEED),
                            BOOT_REPS)
    boot = torch.as_tensor(_boot_draws(want))
    est, lb = bootstrap_bounds(solver.pa, solver.cfg, want, boot)
    verdicts = [full_test(solver.pa, dataclasses.replace(solver.cfg,
                                                         EPSILON=eps),
                          want, boot) for eps in EPSILONS]
    assert verdicts[0] is False and verdicts[-1] is True

    def fractions(est, lb):
        gap = np.abs((np.asarray(est) - np.asarray(lb)) /
                     float(want.incumb_est))
        return [float(np.mean(gap <= eps)) for eps in EPSILONS]

    for out, arrays in mine:
        np.testing.assert_array_equal(arrays[f"{tag}/boot_draws"],
                                      draws.numpy())
        assert _rel(arrays[f"{tag}/boot_est"], est) <= 1e-9
        assert _rel(arrays[f"{tag}/boot_lb"], lb) <= 1e-9
        assert out[tag]["verdicts"] == verdicts
        assert fractions(arrays[f"{tag}/boot_est"],
                         arrays[f"{tag}/boot_lb"]) == fractions(est, lb)


def _compare(seq, reps):
    assert [r["rep"] for r in reps] == list(range(len(seq.replications)))
    for rs, rm in zip(seq.replications, reps):
        assert rs.iterations == rm["iterations"], rs.rep
        assert rs.optimal == rm["optimal"]
        np.testing.assert_allclose(rm["incumb_x"], rs.incumb_x,
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(rm["incumb_est"], rs.incumb_est,
                                   rtol=1e-8, atol=1e-8)
        assert rs.unique_omegas == rm["unique_omegas"]
        assert rs.pool_sizes == rm["pool_sizes"]
        assert rs.feas_rounds == rm["feas_rounds"]


@pytest.mark.parametrize("job", RUNS, ids=[j["tag"] for j in RUNS])
def test_meshed_run_matches_sequential(obs_run, job):
    _, ranks = obs_run
    seq = worker.solver_for(job).run()
    got = [out[f"run/{job['tag']}"] for out, _ in ranks]
    for g in got[1:]:
        assert g["replications"] == got[0]["replications"]
    _compare(seq, got[0]["replications"])
    if job["cfg"].get("COMPROMISE_PROB"):
        np.testing.assert_allclose(got[0]["compromise_x"], seq.compromise_x,
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got[0]["average_x"], seq.average_x,
                                   rtol=1e-6, atol=1e-8)
        assert all(g["compromise_x"] is None for g in got[1:])
    if job["tag"] in ("spread", "spread_d"):
        assert min(r.unique_omegas for r in seq.replications) > \
            SDSolver(port_problem(job["name"]), SDConfig(**job["cfg"]),
                     device="cpu").caps.O // 2


def pa_randcost(solver):
    return solver.pa.rv_d_cols.shape[0] > 0


def test_sharded_resume_is_bit_identical_and_resumes_on_2x1(obs_run):
    """A24: a 2x2 run of spread checkpoints every RESUME_EVERY samples; what
    a run killed after two checkpoints of each replication leaves resumes
    over 2x2 bit for bit, and over 2x1 within tests/test_mesh_runner.py's
    rules; the files hold every observation column (the full O)."""
    tmp, ranks = obs_run
    whole = [out["resume/whole"] for out, _ in ranks]
    for w in whole[1:]:
        assert w["replications"] == whole[0]["replications"]
    reps = whole[0]["replications"]
    solver = worker.solver_for(RESUME)
    O = solver.caps.O
    expected = []
    for r in reps:
        expected.append(f"mesh_wave00_rep{r['rep']:02d}_final.npz")
        expected += [f"mesh_wave00_rep{r['rep']:02d}_k{k:06d}.npz"
                     for k in range(RESUME_EVERY, r["iterations"] + 1,
                                    RESUME_EVERY)]
    assert ranks[0][0]["resume/files"] == sorted(expected)
    kept = ranks[0][0]["resume/kept"]
    assert kept == [f"mesh_wave00_rep{r:02d}_k{k:06d}.npz"
                    for r in (0, 1) for k in (100, 200)]
    for name in kept[1::2]:            # the files the resumes start from
        with np.load(tmp / "resume_whole" / name) as f:
            assert int(f["omega_cnt"]) > O // 2
            assert list(f["__host_shape_delta_pib"]) == [solver.caps.L, O]
            assert f["omega_vals"].shape[0] > O // 2
    for out, _ in ranks:
        assert out["resume/2x2"]["replications"] == reps
    _compare(SDSolver(port_problem("spread"), SDConfig(**RESUME["cfg"]),
                      device="cpu").run(), reps)
    got = ranks[0][0]["resume/2x1"]["replications"]
    for out, _ in ranks[1:]:
        assert out["resume/2x1"]["replications"] == got
    for a, b in zip(got, reps):
        assert (a["iterations"], a["optimal"], a["unique_omegas"],
                a["pool_sizes"]) == (b["iterations"], b["optimal"],
                                     b["unique_omegas"], b["pool_sizes"])
        np.testing.assert_allclose(a["incumb_x"], b["incumb_x"],
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(a["incumb_est"], b["incumb_est"],
                                   rtol=1e-8, atol=1e-8)


def test_a_checkpoint_loads_into_each_obs_block(tmp_path):
    """One file, written unsharded, loads into either obs block of a 1x2
    mesh: each block holds its columns of the five observation-axis
    fields, and every other field whole."""
    from stochasticdecomposition_torch.utils.checkpoint import (
        load_state, save_state,
    )

    solver, state = _port_steps("spread", 90, 1, 120)
    path = str(tmp_path / "spread.npz")
    save_state(path, state)
    O = state.omega_w.shape[0]
    for lo, hi in ((0, O // 2), (O // 2, O)):
        like = init_state(solver.pa, solver.caps, solver.cfg,
                          solver.mean_sol, ObsShard(lo, hi, 2))
        got = load_state(path, like)
        assert got.shard == like.shard
        want = worker.shard_state(state, ObsShard(lo, hi, 2))
        for f in state._fields:
            if f in ("shard", "lane_iters"):
                continue
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f
            else:
                assert a == b, f
    assert state.omega_cnt > O // 2


def test_cli_over_a_2x2_mesh_matches_one_process(obs_run, tmp_path):
    tmp, ranks = obs_run
    assert [out["cli_rc"] for out, _ in ranks] == [0] * WORLD
    assert cli.main(CLI_RUN + ["-o", str(tmp_path / "plain")]) == 0
    plain = tmp_path / "plain" / "twoSD_torch" / "lands"
    mesh = tmp / "cli_rank0" / "twoSD_torch" / "lands"
    assert sorted(os.listdir(mesh)) == sorted(os.listdir(plain))
    assert not any(os.path.exists(tmp / f"cli_rank{r}") for r in (1, 2, 3))
    np.testing.assert_allclose(np.loadtxt(mesh / "incumb.dat"),
                               np.loadtxt(plain / "incumb.dat"),
                               rtol=1e-8, atol=1e-8)


def test_a_rank_out_of_lockstep_fails_every_rank(obs_run):
    _, ranks = obs_run
    for out, _ in ranks:
        msg = out["lockstep"]
        assert msg is not None and "replication" in msg and \
            "out of lockstep" in msg, msg


def test_obs_groups_built_once_and_collectives_in_step(obs_run):
    _, ranks = obs_run
    got = [out["groups"] for out, _ in ranks]
    assert all(g["shared"] for g in got), got
    for group in (0, 1):
        a, b = got[2 * group], got[2 * group + 1]
        assert a["obs_calls"] == b["obs_calls"] > 0, got
        assert a["obs_seconds"] > 0.0 and b["obs_seconds"] > 0.0, got


def test_refusals_and_per_rank_bytes():
    # An O the obs ranks do not divide.
    with pytest.raises(ValueError, match="not divisible by the obs mesh"):
        Mesh(n_rep=1, n_obs=3, world=3, rank=0).obs_block(128)
    assert Mesh(1, 4, 4, 2).obs_block(128) == (64, 96)
    assert Mesh(2, 2, 5, 4).obs_block(128) == (0, 64)   # past the mesh
    assert Mesh(1, 1, 1, 0).obs_shard(128) is None
    assert Mesh(1, 2, 2, 1).obs_shard(128) == ObsShard(64, 128, 2)
    # Every rank refuses before any work (no process group is needed).
    # Checkpoints, resume and random costs over obs ranks run (the 2x2
    # runs above); an O the obs ranks do not divide is refused.
    cfg = dict(MAX_ITER=20, EVAL_FLAG=False)
    lands = SDSolver(port_problem("lands"), SDConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        run_replications_meshed(lands, Mesh(1, 3, 3, 0), checkpoint_every=5,
                                checkpoint_dir="unused")

    # The pool bytes of one rank: the obs-axis fields at O / n_obs, the
    # [L, O, 1] delta_piC placeholder counted, as the state allocates them.
    sp = port_problem("spread")
    cfg = SDConfig(MAX_ITER=120, EVAL_FLAG=False)
    caps = derive_capacities(sp, cfg)
    pa = stage_problem(sp, CPU)
    for n_obs in (1, 2, 4):
        est = estimate_pool_bytes(sp, caps, cfg, n_obs)
        per = caps.O // n_obs
        shard = None if n_obs == 1 else ObsShard(0, per, n_obs)
        st = init_state(pa, caps, cfg, np.zeros(pa.c1.shape[0]), shard)
        for key, fields in (("omega", ("omega_vals", "omega_w")),
                            ("delta_pib", ("delta_pib",)),
                            ("delta_piC", ("delta_piC",))):
            assert est[key] == sum(getattr(st, f).nbytes for f in fields)
        assert st.cut_istar.shape == (caps.K, per)
    plain = port_problem("lands")
    placeholder = estimate_pool_bytes(plain, derive_capacities(plain, cfg),
                                      cfg)["delta_piC"]
    st = init_state(stage_problem(plain, CPU), derive_capacities(plain, cfg),
                    cfg, np.zeros(4))
    assert placeholder == st.delta_piC.nbytes > 0
