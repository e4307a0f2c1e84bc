"""The port's replications over several ranks against its sequential run.

``tests/torch_mesh_worker.py`` runs as four (or two) processes joined by
``torch.distributed`` over ``gloo`` (a ``file://`` store under the test's
temporary directory, so that concurrent test workers never share a port):
the CPU emulation of one process per card, as ``tests/test_multihost.py``
emulates several hosts for the JAX package.  Every rank leaves its process
groups before it exits (``distributed.shutdown``) and exits 0: a teardown
run repeated several times must end with rc 0 on every rank.  The meshed
runs must equal the in-process sequential ``SDSolver.run(device="cpu")`` by
``tests/test_mesh_runner.py``'s rules: iterations, ``optimal``,
``unique_omegas`` and pool sizes exact, incumbents and estimates within
1e-8, the compromise within 1e-6; every rank returns the same results, and
only rank 0 holds the compromise.  A wave resumed from its checkpoints,
with the wave before it rebuilt from its final files, is bit-identical to
the uninterrupted run.  The sharded evaluation equals the port's
``make_eval_batch`` on the same generator, and the JAX package's
``make_eval_batch`` on the JAX package's draws, injected (``n_ok`` exact,
mean within 1e-10, M2 within 1e-8 relative, as ``tests/test_io_cli.py``
holds the JAX package's).  The CLI over two ranks (``--mesh 2x1
--distributed``, the group joined from the environment) names each rank's
device, drops the metrics stream with a note, and writes the files of the
run without a mesh on rank 0 only.  A failure on one rank fails every rank
within the timeout.  Every process is killed at its timeout.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch import cli
from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.evaluate import (
    eval_generator, make_eval_batch,
)
from stochasticdecomposition_torch.parallel import distributed
from stochasticdecomposition_torch.parallel.mesh import Mesh, make_mesh
from stochasticdecomposition_torch.runner import SDSolver
from stochasticdecomposition_tpu.core import evaluate as jeval
import torch_mesh_worker as worker
from torch_common import jax_sample, jax_solver, port_problem

HERE = os.path.dirname(os.path.abspath(__file__))

TIMEOUT = 240


def _launch(scenario, world, tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
        env.get("PYTHONPATH", "")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
                 "PROCESS_ID"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
         scenario, str(r), str(world), str(tmp / "store"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
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
def jax_eval():
    """The JAX package's evaluation batch of ``EVAL_LANES`` lanes on
    pgp2like at its mean-value solution: (x, its draws, (mean, M2, n_ok))."""
    js = jax_solver("pgp2like", MAX_ITER=40)
    x = np.array(js.mean_sol)
    key = jax.random.PRNGKey(worker.EVAL_SEED)
    want = jeval.make_eval_batch(js.pa, js.spec, worker.EVAL_LANES)(
        jnp.asarray(x), key)
    draws = np.array(jax_sample(js.spec, key, worker.EVAL_LANES,
                                dtype=jnp.float64))
    return x, draws, tuple(float(v) for v in want)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory, jax_eval):
    tmp = tmp_path_factory.mktemp("mesh")
    x, draws, _ = jax_eval
    np.savez(tmp / "eval_inputs.npz", x=x, w_raw=draws)
    for r, (rc, out, err) in enumerate(_launch("main", 4, tmp)):
        assert rc == 0, f"rank {r} failed:\n{out[-2000:]}\n{err[-4000:]}"
    return [json.load(open(tmp / f"main_rank{r}.json")) for r in range(4)]


def _sequential(key):
    name, _, cfg_kw = worker.CONFIGS[key]
    solver = SDSolver(port_problem(name), SDConfig(**cfg_kw), device="cpu")
    return solver.run()


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


def _every_rank_agrees(runs, key):
    for run in runs[1:]:
        assert run[key]["replications"] == runs[0][key]["replications"]


def test_lands_2x2_matches_sequential(main_run):
    seq = _sequential("lands_2x2")
    _every_rank_agrees(main_run, "lands_2x2")
    _compare(seq, main_run[0]["lands_2x2"]["replications"])
    assert [r["lands_2x2"]["coords"] for r in main_run] == \
        [[0, 0], [0, 1], [1, 0], [1, 1]]
    # The compromise: on the coordinator only.
    head = main_run[0]["lands_2x2"]
    np.testing.assert_allclose(head["compromise_x"], seq.compromise_x,
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(head["average_x"], seq.average_x,
                               rtol=1e-6, atol=1e-8)
    assert all(r["lands_2x2"]["compromise_x"] is None for r in main_run[1:])


def test_feastest_2x2_matches_sequential(main_run):
    seq = _sequential("feastest_2x2")
    assert any(r.feas_rounds > 0 for r in seq.replications)
    _every_rank_agrees(main_run, "feastest_2x2")
    _compare(seq, main_run[0]["feastest_2x2"]["replications"])


def test_waves_with_an_idle_slot_match_sequential(main_run):
    """Three replications on a 2x1 mesh of a four-rank world: two waves,
    the second with group 1 idle; ranks 2 and 3 lie past the mesh and take
    no replication but return the results all the same."""
    seq = _sequential("lands_waves")
    _every_rank_agrees(main_run, "lands_waves")
    _compare(seq, main_run[0]["lands_waves"]["replications"])
    assert [r["lands_waves"]["coords"] for r in main_run] == \
        [[0, 0], [1, 0], None, None]


def test_checkpoint_cadence_and_bit_identical_resume(main_run):
    whole = main_run[0]["ckpt_whole"]["replications"]
    _compare(_sequential("lands_ckpt"), whole)
    # SAMPLE_INCREMENT 4: k advances by 4, so checkpoints fall where k has
    # advanced by CKPT_EVERY since the last one (elapsed k).
    batch = worker.CONFIGS["lands_ckpt"][2]["SAMPLE_INCREMENT"]
    expected = []
    for r in whole:
        wave = r["rep"] - r["rep"] % 2
        expected.append(f"mesh_wave{wave:02d}_rep{r['rep']:02d}_final.npz")
        last = 0
        for k in range(batch, r["iterations"] + 1, batch):
            if k - last >= worker.CKPT_EVERY:
                expected.append(
                    f"mesh_wave{wave:02d}_rep{r['rep']:02d}_k{k:06d}.npz")
                last = k
    assert main_run[0]["ckpt_files"] == sorted(expected)
    # Resumed in wave 2: replications 0-1 rebuilt from their final files,
    # 2-3 continued from their newest checkpoints — bit for bit.
    resumed = main_run[0]["ckpt_resumed"]
    assert resumed["resume_from"] == "mesh_wave02_rep02_k000012.npz"
    _every_rank_agrees(main_run, "ckpt_resumed")
    assert resumed["replications"] == whole


def test_sharded_eval_matches_eval_batch(main_run):
    solver = SDSolver(port_problem("pgp2like"),
                      SDConfig(MAX_ITER=40, EVAL_FLAG=False), device="cpu")
    mean, m2, n_ok, n = make_eval_batch(
        solver.pa, solver.spec, worker.EVAL_LANES)(
            solver.mean_sol, eval_generator(worker.EVAL_SEED, "cpu"))
    for run in main_run:
        s_mean, s_m2, s_ok, s_n = run["sharded_eval"]
        assert (s_ok, s_n) == (n_ok, n) == (worker.EVAL_LANES,) * 2
        np.testing.assert_allclose(s_mean, mean, rtol=1e-10)
        np.testing.assert_allclose(s_m2, m2, rtol=1e-8)


def test_sharded_eval_matches_jax_on_injected_draws(main_run, jax_eval):
    mean, m2, n_ok = jax_eval[2]
    assert n_ok == worker.EVAL_LANES
    for run in main_run:
        s_mean, s_m2, s_ok, s_n = run["sharded_eval_injected"]
        assert (s_ok, s_n) == (n_ok, worker.EVAL_LANES)
        np.testing.assert_allclose(s_mean, mean, rtol=1e-10)
        np.testing.assert_allclose(s_m2, m2, rtol=1e-8)


_NUMBER = re.compile(r"-?\d+(\.\d+)?([eE][-+]?\d+)?")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _numbers(path):
    with open(path) as fh:
        return [float(m.group(0)) for m in _NUMBER.finditer(fh.read())]


def test_cli_over_two_ranks_writes_on_rank_0_only(tmp_path):
    runs = _launch("cli", 2, tmp_path)
    for r, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"rank {r} failed:\n{out[-2000:]}\n{err[-4000:]}"
        # The CLI joined the group of two and left it before returning.
        assert json.load(open(tmp_path / f"cli_rank{r}.json")) == \
            {"rc": 0, "world": 1}
        assert f"rank {r} of 2: cpu (CPU)" in out
        assert "--metrics-every and --time-phases are not taken" in err
    assert "Starting two-stage" in runs[0][1]
    assert "Starting two-stage" not in runs[1][1]
    assert not os.path.exists(tmp_path / "cli_rank1")
    # Rank 0 writes what one process writes without a mesh, and no metrics.
    assert cli.main(worker.CLI_RUN + ["-o", str(tmp_path / "plain")]) == 0
    plain, mesh = (tmp_path / d / "twoSD_torch" / "lands"
                   for d in ("plain", "cli_rank0"))
    assert _tree(mesh) == _tree(plain)
    assert not any(f.startswith("metrics") for f in _tree(mesh))
    np.testing.assert_allclose(_numbers(mesh / "incumb.dat"),
                               _numbers(plain / "incumb.dat"),
                               rtol=1e-8, atol=1e-8)


TEARDOWN_RUNS = 3


def test_every_rank_exits_0_after_leaving_its_groups(tmp_path):
    """The groups scenario (four ranks, the obs groups of a 2x2 mesh, a
    thousand gathers, the lead ranks working on while the others leave)
    several times in a row: every rank leaves its groups
    (``distributed.shutdown``) and exits 0.  Before the ranks left them, a
    rank aborted at the interpreter's exit in most such runs."""
    for run in range(TEARDOWN_RUNS):
        tmp = tmp_path / f"run{run}"
        tmp.mkdir()
        for r, (rc, out, err) in enumerate(_launch("groups", 4, tmp)):
            assert rc == 0, f"run {run}, rank {r}: rc {rc}\n{err[-2000:]}"
            assert f"rank {r} ok" in out
            got = json.load(open(tmp / f"groups_rank{r}.json"))
            g = r // 2                     # rep group: ranks 2g, 2g + 1
            assert got["obs_sum"] == [float(4 * g + 1)] * 3
            assert got["gathered"] == [[q, worker.GROUP_ROUNDS - 1]
                                       for q in range(4)]


def test_shutdown_in_one_process_does_nothing():
    assert not torch.distributed.is_initialized()
    distributed.shutdown()
    distributed.shutdown(barrier=False)
    assert distributed.process_count() == 1


def test_cli_meshed_checkpoints_need_a_directory(tmp_path, capsys):
    assert cli.main(["-p", "lands", "-o", str(tmp_path), "--device", "cpu",
                     "--mesh", "1x1", "--checkpoint-every", "5"]) == 2
    assert "--checkpoint-dir" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "twoSD_torch")


def test_a_failed_replication_fails_every_rank(tmp_path):
    for r, (rc, out, err) in enumerate(_launch("fail", 2, tmp_path)):
        assert rc != 0, f"rank {r} exited 0:\n{out}"
        assert "RuntimeError: replication 1 failed" in err, err[-4000:]
        assert "injected failure in replication 1" in err
        assert not os.path.exists(tmp_path / f"fail_rank{r}.json")


def test_one_process_mesh_and_its_refusals(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize() is False
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    assert make_mesh() == Mesh(1, 1, 1, 0)
    for shape in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(*shape)
    # A mesh of one rank runs the sequential path's replications.
    cfg = dict(MAX_ITER=30, EVAL_FLAG=False, MULTIPLE_REP=2,
               COMPROMISE_PROB=True)
    solver = SDSolver(port_problem("lands"), SDConfig(**cfg), device="cpu")
    seq, msh = solver.run(), solver.run(mesh=make_mesh(1, 1))
    for a, b in zip(seq.replications, msh.replications):
        assert a.iterations == b.iterations
        np.testing.assert_array_equal(a.incumb_x, b.incumb_x)
    np.testing.assert_array_equal(seq.compromise_x, msh.compromise_x)
    with pytest.raises(ValueError, match="metrics"):
        solver.run(mesh=make_mesh(1, 1), time_phases=True)
    # MILP/MIQP masters run on the sequential path only, as in JAX.
    solver = SDSolver(port_problem("intcaplike"),
                      SDConfig(MAX_ITER=10, EVAL_FLAG=False, MASTER_TYPE=7),
                      device="cpu")
    with pytest.raises(ValueError, match="MILP/MIQP"):
        solver.run(mesh=make_mesh(1, 1))


def test_mesh_layout():
    """rank = rep_coord * n_obs + obs_coord; replication r runs on its rep
    group's lead rank; ranks past R*O have no coordinates."""
    mesh = Mesh(n_rep=2, n_obs=3, world=7, rank=4)
    assert mesh.coords() == (1, 1)
    assert [mesh.coords(r) for r in range(7)] == \
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), None]
    assert [mesh.lead_rank(rep) for rep in range(5)] == [0, 3, 0, 3, 0]


def test_rank_device_keeps_the_cpu_and_needs_a_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.rank_device(None)
