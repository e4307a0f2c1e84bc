"""The experiment drivers: the port's ``sweep.py`` and ``suite_to_stop.py``
against the JAX package's root ``sweep.py`` and ``scripts/suite_to_stop.py``.

- (a) ``_parity_oracle`` of both drivers on lands, pgp2like, cep1like and
  baa99like: the extensive-form optimum and the exact objective at three
  seeded first-stage points within PARITY_RTOL (1e-9) relative.
- (b) The TSV header and the JSONL keys of both drivers are equal: both
  ``main``s write their files from the same results byte for byte; a port
  grid (lands, tolerance l, SAMPLE_INCREMENT 1 and 16, MAX_ITER 300, no
  evaluation, on the CPU) writes both files with the JAX driver's columns,
  each row's ef_opt within PARITY_RTOL of the JAX oracle's.
- (c) ``suite_to_stop``'s configuration and derived pool capacities equal
  the JAX script's for stormlike, ssnlike and 20termlike at SAMPLE_INCREMENT
  64, CHECK_EVERY 4 and MAX_ITER 4096 (exact).
- (d) ``python -m stochasticdecomposition_torch.suite_to_stop cep1like
  --si 16 --device cpu`` (pools pinned to 256) prints one JSON line with
  every key of the JAX script's line, stopped statistically.
"""

import ast
import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest

import sweep as jax_sweep
from stochasticdecomposition_torch import suite_to_stop
from stochasticdecomposition_torch import sweep as port_sweep
from stochasticdecomposition_torch.core.evaluate import EvalResult
from stochasticdecomposition_torch.core.state import (
    derive_capacities, stage_problem,
)
from stochasticdecomposition_torch.models.extensive import (
    enumerate_scenarios, solve_extensive_form,
)
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from stochasticdecomposition_tpu.core.state import (
    derive_capacities as jax_derive_capacities,
    stage_problem as jax_stage_problem,
)
from stochasticdecomposition_tpu.prob import decompose as jax_decompose
from stochasticdecomposition_tpu.runner import attach_stoc as jax_attach_stoc
from torch_common import CPU, port_problem

ROOT = Path(__file__).resolve().parent.parent
PARITY_RTOL = 1e-9
MAX_SCEN = 100_000


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


def _jax_oracle(name):
    core, tim, stoc = jax_sweep._load(name)
    sp = jax_attach_stoc(jax_decompose(core, tim, stoc), stoc)
    solver = types.SimpleNamespace(sp=sp, pa=jax_stage_problem(sp))
    return jax_sweep._parity_oracle(name, solver, stoc, MAX_SCEN)


def _port_oracle(name):
    sp = port_problem(name)
    solver = types.SimpleNamespace(sp=sp, pa=stage_problem(sp, CPU),
                                   device=CPU)
    return port_sweep._parity_oracle(name, solver, sp._stoc, MAX_SCEN), sp


@pytest.mark.parametrize("name", ["lands", "pgp2like", "cep1like",
                                  "baa99like"])
def test_parity_oracles_agree(name):
    (ef, exact), sp = _port_oracle(name)
    jef, jexact = _jax_oracle(name)
    assert _rel(ef, jef) <= PARITY_RTOL
    # Three points around the extensive form's first stage, within bounds.
    outs, probs = enumerate_scenarios(sp._stoc, sp.rv_order)
    _, x0 = solve_extensive_form(sp, outs, probs)
    rng = np.random.default_rng(13)
    lo, hi = sp.first.lb, sp.first.ub
    for _ in range(3):
        x = np.clip(x0 * rng.uniform(0.8, 1.2, x0.shape) +
                    rng.uniform(0.0, 0.5, x0.shape), lo, hi)
        assert _rel(exact(x), jexact(x)) <= PARITY_RTOL, x


def _fake_rows():
    """(run_one's result) for each row of a 2 x 1 x 2 grid: what both
    drivers' ``main`` format."""
    ev = EvalResult(mean=101.25, stdev=0.5, count=512, ci_low=100.75,
                    ci_high=101.75, error=0.0016, dropped=0)
    rows = {}
    for i, (name, batch) in enumerate([("lands", 1), ("lands", 16),
                                       ("pgp2like", 1), ("pgp2like", 16)]):
        r = types.SimpleNamespace(
            iterations=100 + i, optimal=bool(i % 2), incumb_est=99.5 + i,
            pool_sizes={"omega": 3, "lam": 14 + i, "sigma": 15, "cuts": 7})
        rows[name, batch] = (r, ev if i != 2 else None, 1.25 + i,
                             382.0222 if i != 3 else None,
                             1e-4 * i if i != 3 else None)
    return rows


def test_header_and_jsonl_keys_match_jax(tmp_path, monkeypatch, capsys):
    assert port_sweep.HEADER == jax_sweep.HEADER
    rows = _fake_rows()

    def fake(name, tol, batch, *a, **kw):
        if name == "pgp2like" and batch == 16 and tol == "l":
            raise RuntimeError("no stop")
        return rows[name, batch]

    files = {}
    for tag, mod in (("jax", jax_sweep), ("port", port_sweep)):
        monkeypatch.setattr(mod, "run_one", fake)
        out = tmp_path / tag
        argv = ["-p", "lands,pgp2like", "-t", "l", "-s", "1,16", "-o",
                str(out)]
        assert mod.main(argv + (["--device", "cpu"] if tag == "port"
                                else [])) == 0
        files[tag] = [(out / f).read_text() for f in
                      ("sweep_results.tsv", "sweep_results.jsonl")]
    capsys.readouterr()
    assert files["port"] == files["jax"]
    assert "ERROR: no stop" in files["port"][0]


def test_port_grid_writes_the_jax_columns(tmp_path):
    out = tmp_path / "grid"
    assert port_sweep.main(["-p", "lands", "-t", "l", "-s", "1,16",
                            "--max-iter", "300", "-e", "0", "--parity",
                            str(MAX_SCEN), "-o", str(out),
                            "--device", "cpu"]) == 0
    header, *rows = (out / "sweep_results.tsv").read_text().splitlines()
    assert header + "\n" == jax_sweep.HEADER
    cols = header.split("\t")
    assert len(rows) == 2
    jef, _ = _jax_oracle("lands")
    for row, batch in zip(rows, (1, 16)):
        fields = dict(zip(cols, row.split("\t")))
        assert len(row.split("\t")) == len(cols)
        assert (fields["problem"], fields["tolerance"], fields["batch"]) \
            == ("lands", "l", str(batch))
        assert fields["eval_ub"] == "-"
        assert abs(float(fields["ef_opt"]) - jef) <= 1e-4   # 4 decimals
    recs = [json.loads(ln) for ln in
            (out / "sweep_results.jsonl").read_text().splitlines()]
    assert len(recs) == 2
    for rec in recs:
        assert _rel(rec["ef_opt"], jef) <= PARITY_RTOL
        assert rec["eval"] is None and rec["exact_gap"] >= 0.0
        assert 0 < rec["iterations"] <= 300 + 16


def _jax_script_cfg(si, max_iter, check_every, tol):
    """The configuration ``scripts/suite_to_stop.py`` builds (l.74-79)."""
    cfg = JaxConfig(MAX_ITER=max_iter, EVAL_FLAG=False, SAMPLE_INCREMENT=si,
                    CHECK_EVERY=check_every, SUBPROB_F32_PIVOT=False,
                    MAX_LAMBDA=None, MAX_SIGMA=None, MAX_OMEGA=None)
    return cfg.apply_tolerance_preset(tol)


@pytest.mark.parametrize("name", ["stormlike", "ssnlike", "20termlike"])
def test_suite_config_and_capacities_match_jax(name):
    cfg = suite_to_stop.suite_config("l", 64, 4096, 4)
    jcfg = _jax_script_cfg(64, 4096, 4, "l")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sp = port_problem(name)
    core, tim, stoc = jax_sweep._load(name)
    jsp = jax_attach_stoc(jax_decompose(core, tim, stoc), stoc)
    caps = derive_capacities(sp, cfg)
    assert tuple(caps) == tuple(jax_derive_capacities(jsp, jcfg))
    assert caps._fields == jax_derive_capacities(jsp, jcfg)._fields
    assert caps.O == 4224 and caps.L == caps.S == 6145


def _jax_line_keys():
    """The keys of the JSON line in ``scripts/suite_to_stop.py``'s main."""
    tree = ast.parse((ROOT / "scripts" / "suite_to_stop.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets] == ["out"]:
            return {k.value for k in node.value.keys}
    raise AssertionError("no JSON line in scripts/suite_to_stop.py")


def test_suite_to_stop_prints_the_jax_line(capsys):
    assert suite_to_stop.main(["cep1like", "--si", "16", "--max-lambda",
                               "256", "--max-omega", "256",
                               "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    line = json.loads(lines[-1])
    keys = _jax_line_keys()
    assert len(keys) == 17
    assert set(line) == keys
    assert line["stopped_statistically"] is True
    assert line["device"] == "cpu" and line["sample_increment"] == 16
    assert line["pools"]["omega"] <= 256 and line["samples_per_s_steady"] > 0
