"""The port's command line (``python -m stochasticdecomposition_torch.cli``)
against the JAX package's.

- The parser takes every option string of the JAX CLI, plus ``--device``;
  ``apply_seed_offset`` rotates the seed banks as JAX's does.
- The same arguments (two replications with the compromise, checkpoints,
  the metrics stream and phase times; ``--device cpu`` for the port) write
  the same files: the same names under ``twoSD_torch/<prob>/`` as under
  ``twoSD_tpu/<prob>/``, the same ``detailedResults.csv`` header, rows and
  columns (phase columns >= 0), the same ``summary.dat`` lines with their
  numbers masked (the "Algorithm" line names the implementation), and the
  same metrics keys.  The values differ: the draws differ.
- ``--resume`` continues replication 0 from one of the run's checkpoints,
  a missing resume file and an unknown problem return 2, and without a card
  and without ``--device cpu`` the run raises the port's no-CUDA error.
  ``--mesh 1x1`` in one process writes what the run without it writes; a
  mesh larger than the world of ranks, or malformed, returns 2 (the runs
  over several ranks: ``tests/test_torch_mesh.py``).
- Behind ``--time-phases`` and the metrics stream: the phase-time estimate
  runs on copies of the final state, so a replication's result is the same
  with and without it (exact), with four phase times >= 0 instead of -1;
  ``profile_steps`` writes a trace of the steps it runs.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from stochasticdecomposition_torch import cli
from stochasticdecomposition_torch.config import SDConfig
from stochasticdecomposition_torch.core.state import init_state
from stochasticdecomposition_torch.runner import (
    SDSolver, replication_generators,
)
from stochasticdecomposition_torch.utils.metrics import profile_steps
from stochasticdecomposition_tpu import cli as jax_cli
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from torch_common import port_problem

ARGS = ["-p", "lands", "-m", "2", "-c", "1", "--max-iter", "40",
        "--metrics-every", "5", "--time-phases", "--checkpoint-every", "10"]
_NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def _options(parser):
    return sorted(s for a in parser._actions for s in a.option_strings)


def test_parser_takes_the_jax_options_and_device():
    assert _options(cli.build_parser()) == sorted(
        _options(jax_cli.build_parser()) + ["--device"])
    args = cli.build_parser().parse_args(["-p", "lands"])
    assert args.device == "cuda"


@pytest.mark.parametrize("offset", [0, 1, 7, 31])
def test_seed_offset_matches_jax(offset):
    mine = cli.apply_seed_offset(SDConfig(), offset)
    theirs = jax_cli.apply_seed_offset(JaxConfig(), offset)
    assert mine.RUN_SEED == theirs.RUN_SEED
    assert mine.EVAL_SEED == theirs.EVAL_SEED


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _masked(path):
    with open(path) as fh:
        return [_NUMBER.sub("#", ln.replace("(TPU)", "(PyTorch)"))
                for ln in fh.read().splitlines()]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    assert cli.main(ARGS + ["-o", str(out / "port"), "--device", "cpu"]) == 0
    assert jax_cli.main(ARGS + ["-o", str(out / "jax")]) == 0
    return (str(out / "port" / "twoSD_torch" / "lands"),
            str(out / "jax" / "twoSD_tpu" / "lands"))


def test_cli_writes_the_jax_files(both_runs):
    port, jax = both_runs
    assert _tree(port) == _tree(jax)
    assert {"detailedResults.csv", "incumb.dat", "results.jsonl",
            "summary.dat", "metrics_rep00.jsonl", "metrics_rep01.jsonl",
            os.path.join("checkpoints", "rep01_k000040.npz")} <= \
        set(_tree(port))
    rows = [ln.split("\t") for ln in
            open(os.path.join(port, "detailedResults.csv")).read()
            .splitlines()]
    jrows = [ln.split("\t") for ln in
             open(os.path.join(jax, "detailedResults.csv")).read()
             .splitlines()]
    assert rows[0] == jrows[0]
    assert [len(r) for r in rows] == [len(r) for r in jrows] == [13, 13, 13]
    assert all(float(v) >= 0 for r in rows[1:] for v in r[3:8])
    assert _masked(os.path.join(port, "summary.dat")) == \
        _masked(os.path.join(jax, "summary.dat"))
    summary = open(os.path.join(port, "summary.dat")).read()
    assert summary.index("Compromise solution") < \
        summary.index("Average solution")
    for rep in ("00", "01"):
        recs = [json.loads(ln) for ln in
                open(os.path.join(port, f"metrics_rep{rep}.jsonl"))]
        jrecs = [json.loads(ln) for ln in
                 open(os.path.join(jax, f"metrics_rep{rep}.jsonl"))]
        assert [r["k"] for r in recs] == [r["k"] for r in jrecs] == \
            list(range(5, 41, 5))
        assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]


def test_cli_resumes_from_a_checkpoint(both_runs, tmp_path, capsys):
    port, _ = both_runs
    ckpt = os.path.join(port, "checkpoints", "rep00_k000020.npz")
    assert cli.main(["-p", "lands", "--max-iter", "40", "-e", "0",
                     "--resume", ckpt, "-o", str(tmp_path),
                     "--device", "cpu"]) == 0
    assert "Starting two-stage stochastic decomposition (PyTorch)." in \
        capsys.readouterr().out
    first = open(os.path.join(port, "incumb.dat")).readline()
    again = open(os.path.join(tmp_path, "twoSD_torch", "lands",
                              "incumb.dat")).read()
    assert again == first
    assert cli.main(["-p", "lands", "--resume", str(tmp_path / "none.npz"),
                     "-o", str(tmp_path), "--device", "cpu"]) == 2


def test_cli_refusals(tmp_path, capsys):
    run = ["-p", "lands", "-m", "2", "-c", "1", "--max-iter", "30", "-e",
           "0", "--device", "cpu", "-o"]
    assert cli.main(run + [str(tmp_path / "plain")]) == 0
    assert cli.main(run + [str(tmp_path / "mesh"), "--mesh", "1x1"]) == 0
    plain, mesh = (tmp_path / d / "twoSD_torch" / "lands"
                   for d in ("plain", "mesh"))
    assert _tree(plain) == _tree(mesh)
    assert open(plain / "incumb.dat").read() == \
        open(mesh / "incumb.dat").read()
    assert _masked(plain / "summary.dat") == _masked(mesh / "summary.dat")
    for bad in ("2x1", "2y1"):
        assert cli.main(["-p", "lands", "-o", str(tmp_path), "--device",
                         "cpu", "--mesh", bad]) == 2
        assert "--mesh expects RxO" in capsys.readouterr().err
    assert cli.main(["-p", "no_such_problem", "-o", str(tmp_path),
                     "--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-p", "lands", "-o", str(tmp_path)])
    assert not os.path.exists(tmp_path / "twoSD_torch")


def test_phase_times_leave_the_result_alone():
    solver = SDSolver(port_problem("lands"),
                      SDConfig(MAX_ITER=60, EVAL_FLAG=False, MAX_OMEGA=128,
                               MAX_LAMBDA=512, MAX_SIGMA=512), device="cpu")
    plain = solver.solve_replication(0)
    timed = solver.solve_replication(0, time_phases=True)
    phases = ("time_master", "time_subprob", "time_opttest", "time_argmax")
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(timed, f.name)
        if f.name in phases:
            assert a == -1.0 and b >= 0.0, f.name
        elif f.name == "batch_entry":
            for g in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, g.name),
                                              getattr(b, g.name))
        elif not f.name.startswith("time_"):
            assert np.array_equal(a, b), f.name


def test_profile_steps_writes_a_trace(tmp_path):
    solver = SDSolver(port_problem("lands"),
                      SDConfig(MAX_ITER=8, EVAL_FLAG=False, MAX_OMEGA=128,
                               MAX_LAMBDA=512, MAX_SIGMA=512), device="cpu")
    state = init_state(solver.pa, solver.caps, solver.cfg, solver.mean_sol)
    gen, _ = replication_generators(solver.cfg.RUN_SEED[0], solver.device)
    state = profile_steps(solver.step, state, gen, 3, str(tmp_path))
    assert state.k == 3
    trace = json.load(open(tmp_path / "trace.json"))
    assert len(trace["traceEvents"]) > 0
