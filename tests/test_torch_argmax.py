"""The port's triple masked argmax against the JAX package's.

The plain PyTorch version (what a CPU tensor gets) is held against
``triple_masked_argmax_xla`` and against the Pallas kernel in interpret
mode; the CUDA kernel itself is held against the plain version on the card
(``cuda`` marker here, and ``chip_smoke.py`` phase 2).  Tolerance: exact —
indices and heights must be equal (NaN matching NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.ops import argmax
from stochasticdecomposition_tpu.ops.pallas_argmax import (
    triple_masked_argmax as jax_pallas_argmax,
    triple_masked_argmax_xla,
)
from torch_common import cuda_device  # noqa: F401  (fixture)


def _case(seed, S, O):
    rng = np.random.default_rng(seed)
    # Continuous data: no ties, even after the TPU kernel's f32 rounding.
    H = rng.standard_normal((S, O)) * 50.0
    masks = [rng.random(S) < p for p in (0.8, 0.5, 0.3)]
    return H, masks


def _port(H, masks):
    out = argmax.triple_masked_argmax(
        torch.as_tensor(H), *(torch.as_tensor(m) for m in masks))
    return [o.numpy() for o in out]


def _assert_same(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(g, w)   # exact, NaN == NaN


@pytest.mark.parametrize("shape", [(37, 128), (300, 256)])
def test_plain_matches_xla_and_interpret_kernel(shape):
    S, O = shape
    H, masks = _case(S * 7 + O, S, O)
    got = _port(H, masks)
    jm = [jnp.asarray(m) for m in masks]
    _assert_same(got, triple_masked_argmax_xla(jnp.asarray(H), *jm))
    _assert_same(got, jax_pallas_argmax(jnp.asarray(H), *jm, interpret=True))


@pytest.mark.parametrize("case", ["empty", "ties", "nan"])
def test_edge_cases_match_xla(case):
    S, O = 61, 128
    H, masks = _case(11, S, O)
    if case == "empty":
        masks = [np.zeros(S, bool), masks[1], np.zeros(S, bool)]
    elif case == "ties":
        H = np.full((S, O), 2.5)
    else:
        H[S // 2, :] = np.nan
        H[S // 3, ::2] = np.nan
    got = _port(H, masks)
    _assert_same(got, triple_masked_argmax_xla(
        jnp.asarray(H), *(jnp.asarray(m) for m in masks)))
    if case == "empty":
        assert np.all(got[0] == 0) and np.all(got[1] == -1e300)
    if case == "ties":
        assert np.all(got[0] == 0)


def test_cpu_call_does_not_count_a_launch():
    H, masks = _case(3, 40, 64)
    before = argmax.launches
    _port(H, masks)
    assert argmax.launches == before


def test_wrapper_rejects_bad_inputs():
    H = torch.zeros((4, 3), dtype=torch.float64)
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        argmax.triple_masked_argmax(H.float(), m, m, m)
    with pytest.raises(ValueError):
        argmax.triple_masked_argmax(H.T, m, m, m)        # not contiguous
    with pytest.raises(ValueError):
        argmax.triple_masked_argmax(H, m[:3], m, m)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    for S, O in [(37, 128), (1001, 777)]:
        H, masks = _case(S + O, S, O)
        Ht = torch.as_tensor(H, device=cuda_device)
        mt = [torch.as_tensor(m, device=cuda_device) for m in masks]
        before = argmax.launches
        got = argmax.triple_masked_argmax(Ht, *mt)
        assert argmax.launches == before + 1
        want = argmax.triple_masked_argmax_plain(Ht, *mt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
