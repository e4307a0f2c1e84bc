"""The port's native (C++) MPS core reader against its pure-Python parser
and the JAX package's.

Every field of the parsed ``CoreProblem`` must be equal — names, matrix,
right-hand sides, senses, costs, bounds, integrality, the objective's name
and constant, the RANGES slack map — on every built-in instance, on the
stormlike core (528 x 1259 second stage), and on the BV/LI/UI bounds,
RANGES and synthetic cases of ``tests/test_native_smps.py``.  A g++ that
fails, or is missing, raises: ``read_core`` never falls back to the Python
parser.  The library is rebuilt when its source is newer.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from stochasticdecomposition_torch.models.instances import INSTANCES
from stochasticdecomposition_torch.models.suite import SUITE
from stochasticdecomposition_torch.models.synthetic import random_two_stage
from stochasticdecomposition_torch.smps import core as port_core
from stochasticdecomposition_torch.smps import native
from stochasticdecomposition_tpu.smps.core import _read_core_py as jax_read
from test_native_smps import _INT_BOUNDS_CORE, _RANGES_CORE_N

CASES = {f"instance_{n}": INSTANCES[n][0] for n in sorted(INSTANCES)}
CASES["stormlike"] = random_two_stage(**SUITE["stormlike"])[0]
CASES["synthetic"] = random_two_stage(seed=9, n1=20, m1=3, n2=80, m2=40,
                                      n_rv=5)[0]
CASES["int_bounds"] = _INT_BOUNDS_CORE
CASES["ranges"] = _RANGES_CORE_N


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_python_and_jax(case, tmp_path):
    path = tmp_path / "p.cor"
    path.write_text(CASES[case])
    got = port_core.read_core(str(path))
    _assert_same(got, port_core.read_core(str(path), prefer_native=False))
    _assert_same(got, jax_read(str(path)))
    if case == "stormlike":
        assert got.A.shape[0] == 59 + 528
    if case == "int_bounds":
        assert got.is_integer.tolist() == [True, True, True]
    if case == "ranges":
        assert got.range_slacks == [(0, 4), (1, 5), (2, 6), (3, 7)]


@pytest.fixture
def own_build(tmp_path, monkeypatch):
    """The native module building from a copy of its source into
    ``tmp_path``, with nothing loaded yet."""
    src = tmp_path / "smps_core.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib" / "libx.so")
    monkeypatch.setattr(native, "_lib", None)
    path = tmp_path / "p.cor"
    path.write_text(INSTANCES["lands"][0])

    def no_python(path):
        raise AssertionError("fell back to the Python parser")

    monkeypatch.setattr(port_core, "_read_core_py", no_python)
    return src, str(path)


def test_failing_gpp_raises(own_build):
    src, path = own_build
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_core.read_core(path)
    assert not native.LIB_PATH.exists()
    assert not list(native.LIB_PATH.parent.iterdir())


def test_missing_gpp_raises(own_build, monkeypatch):
    _, path = own_build
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        port_core.read_core(path)


def test_rebuilt_when_the_source_is_newer(own_build):
    src, path = own_build
    assert native.build() > 0.0
    assert native.build() == 0.0
    later = native.LIB_PATH.stat().st_mtime + 10
    os.utime(src, (later, later))
    assert native.build() > 0.0
    assert port_core.read_core(path).A.shape == (9, 16)
