"""Shared helpers of the ``test_torch_*`` files: the JAX package and the
PyTorch port driven on the same inputs, made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.interop import state_from_numpy
from stochasticdecomposition_torch.prob import attach_stoc, decompose
from stochasticdecomposition_torch.models.instances import load_instance
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from stochasticdecomposition_tpu.core.state import init_state as jax_init
from stochasticdecomposition_tpu.models.instances import (
    load_instance as jax_load_instance,
)
from stochasticdecomposition_tpu.prob import decompose as jax_decompose
from stochasticdecomposition_tpu.runner import (
    SDSolver as JaxSolver, attach_stoc as jax_attach_stoc,
)
from stochasticdecomposition_tpu.sampler import sample_omega as jax_sample

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The CUDA card; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def port_problem(name):
    core, tim, stoc = load_instance(name)
    return attach_stoc(decompose(core, tim, stoc), stoc)


def jax_solver(name, **cfg):
    core, tim, stoc = jax_load_instance(name)
    sp = jax_attach_stoc(jax_decompose(core, tim, stoc), stoc)
    return JaxSolver(sp, JaxConfig(EVAL_FLAG=False, **cfg))


def jax_fields(nt):
    """{field: np.ndarray} of a JAX NamedTuple."""
    return {f: np.asarray(v) for f, v in nt._asdict().items()}


def to_port_state(jax_state):
    return state_from_numpy(jax_fields(jax_state), device=CPU)


def jax_step_draw(js, state):
    """The raw observation the JAX step will draw from ``state``: the same
    key split and sampler call as core/step.py makes."""
    _, k_draw = jax.random.split(state.key)
    return np.array(jax_sample(js.spec, k_draw, 1, dtype=jnp.float64)[0])


def jax_states(js, steps, seed=0):
    """JAX states after 0..steps iterations, with the draw of each step."""
    st = jax_init(js.pa, js.caps, js.cfg, js.mean_sol,
                  jax.random.PRNGKey(seed))
    states, draws = [], []
    for _ in range(steps):
        # The jitted step donates its input: keep a copy of each state.
        states.append(jax.tree.map(jnp.copy, st))
        draws.append(jax_step_draw(js, st))
        st = js.step(st)
    states.append(st)
    return states, draws
