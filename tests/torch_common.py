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
from stochasticdecomposition_torch.models.suite import (
    SUITE, load_suite_instance,
)
from stochasticdecomposition_torch.models.synthetic import parse_synthetic
from stochasticdecomposition_tpu.config import SDConfig as JaxConfig
from stochasticdecomposition_tpu.core.state import init_state as jax_init
from stochasticdecomposition_tpu.models.instances import (
    load_instance as jax_load_instance,
)
from stochasticdecomposition_tpu.models.suite import (
    load_suite_instance as jax_load_suite_instance,
)
from stochasticdecomposition_tpu.models.synthetic import (
    parse_synthetic as jax_parse_synthetic,
)
from stochasticdecomposition_tpu.prob import decompose as jax_decompose
from stochasticdecomposition_tpu.runner import (
    SDSolver as JaxSolver, attach_stoc as jax_attach_stoc,
)
from stochasticdecomposition_tpu.sampler import sample_omega as jax_sample

CPU = torch.device("cpu")

# The suite runs in several pytest workers on one host.  The LPs and pools
# here are a few rows wide and gain nothing from torch's intra-op threads,
# while a full thread pool in every worker oversubscribes the cores and its
# idle threads spin: one thread per worker.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The CUDA card; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Instances with random technology (C) coefficients, as the JAX package's
# own tests build them (tests/test_sdcut.py:70, tests/test_e2e.py:52).
RANDC = {
    "randc_s11": dict(seed=11, n_rv=2, support=2, rand_C=2),
    "randc_s2": dict(seed=2, n_rv=2, support=2, rand_C=2, n2=6, m2=4),
}


# Instances with random cost coefficients (the v2.0 path), as the JAX
# package's tests/test_randcost.py builds them: two cost RVs, and one cost
# RV beside two RHS RVs.
RANDD = {
    "randd_s21": dict(seed=21, n_rv=1, support=2, rand_d=2, n2=6, m2=4),
    "randd_s33": dict(seed=33, n_rv=2, support=2, rand_d=1, n2=5, m2=4),
}


# Instances whose draws are almost all distinct (4^7 scenarios: five
# random RHS rows and two random technology entries, or, in ``spread_d``,
# two random cost coefficients), so that a run's observations fill more
# than one obs block of a sharded pool.
SPREAD = {"spread": dict(seed=4, n_rv=5, support=4, rand_C=2),
          "spread_d": dict(seed=4, n_rv=5, support=4, rand_d=2)}


def synthetic_spec(name):
    """The ``parse_synthetic`` arguments of a synthetic test instance, or
    None for a built-in one."""
    return {**RANDC, **RANDD, **SPREAD}.get(name)


def _parsed(name, port):
    spec = synthetic_spec(name)
    if spec is not None:
        return (parse_synthetic if port else jax_parse_synthetic)(**spec)
    if name in SUITE:
        return (load_suite_instance if port else
                jax_load_suite_instance)(name)
    return (load_instance if port else jax_load_instance)(name)


def port_problem(name):
    core, tim, stoc = _parsed(name, port=True)
    return attach_stoc(decompose(core, tim, stoc), stoc)


def jax_solver(name, **cfg):
    core, tim, stoc = _parsed(name, port=False)
    sp = jax_attach_stoc(jax_decompose(core, tim, stoc), stoc)
    return JaxSolver(sp, JaxConfig(EVAL_FLAG=False, **cfg))


def jax_fields(nt):
    """{field: np.ndarray} of a JAX NamedTuple."""
    return {f: np.asarray(v) for f, v in nt._asdict().items()}


def to_port_state(jax_state):
    return state_from_numpy(jax_fields(jax_state), device=CPU)


def jax_step_draw(js, state, batch=1):
    """The raw observations the JAX step will draw from ``state``: the same
    key split and sampler call as core/step.py makes ([R] at batch 1, else
    [batch, R])."""
    _, k_draw = jax.random.split(state.key)
    w = np.array(jax_sample(js.spec, k_draw, batch, dtype=jnp.float64))
    return w[0] if batch == 1 else w


def jax_chunk_draws(js, state, steps, batch):
    """The draws of ``steps`` consecutive JAX steps from ``state`` (the key
    each step leaves behind feeds the next): [steps, batch, R]."""
    key, out = state.key, []
    for _ in range(steps):
        key, k_draw = jax.random.split(key)
        out.append(np.array(jax_sample(js.spec, k_draw, batch,
                                       dtype=jnp.float64)))
    return np.stack(out)


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
