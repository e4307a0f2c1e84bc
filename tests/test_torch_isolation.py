"""The port stands alone: no JAX, nothing of the JAX package, and no run on
the CPU unless asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "stochasticdecomposition_torch"
FORBIDDEN = ("jax", "jaxlib", "stochasticdecomposition_tpu")


def _port_files():
    # The card test runs on a machine without JAX.
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_argmax_cuda.py",
        ROOT / "tests" / "torch_mesh_worker.py",
        ROOT / "tests" / "torch_obs_worker.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_every_module_is_checked():
    """The check walks the whole package: the feasibility, random-cost,
    branch-and-bound and compromise modules, the CLI, checkpoints, metrics,
    the runs over several ranks, the native SMPS reader and the experiment
    drivers (sweep, suite_to_stop) are among the files it reads, and so is
    the ranks' test worker."""
    checked = {str(p.relative_to(PORT)) for p in _port_files()
               if PORT in p.parents}
    for mod in ("core/feasibility.py", "core/randcost.py", "core/bnb.py",
                "core/master.py", "core/step.py", "runner.py",
                "core/compromise.py", "cli.py", "utils/checkpoint.py",
                "utils/metrics.py", "parallel/distributed.py",
                "parallel/mesh.py", "parallel/runner.py", "smps/native.py",
                "sweep.py", "suite_to_stop.py"):
        assert mod in checked, mod
    for worker in ("torch_mesh_worker.py", "torch_obs_worker.py"):
        assert ROOT / "tests" / worker in _port_files()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'stochasticdecomposition_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_solver_without_device_needs_cuda():
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.device import resolve_device
    from stochasticdecomposition_torch.models.instances import load_instance
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.runner import SDSolver

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    core, tim, stoc = load_instance("lands")
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    with pytest.raises(RuntimeError, match="CUDA"):
        SDSolver(sp, SDConfig(MAX_ITER=16, EVAL_FLAG=False))
    assert resolve_device("cpu").type == "cpu"
