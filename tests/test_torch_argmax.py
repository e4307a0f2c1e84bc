"""The port's triple masked argmax against the JAX package's.

The plain PyTorch version (what a CPU tensor gets) is held against
``triple_masked_argmax_xla`` and against the Pallas kernel in interpret
mode.  A numpy model of the CUDA kernel's reduction — ``split_plan``'s
S-splits (row tiles dealt out in turn), row tiles no mask selects skipped
as (-1e300, first row), rows outside a mask taken as (-1e300, s) without
reading H, and the merge of the splits' partials — is held against both on
the edge cases of
``ops/argmax_cases.py``; the CUDA kernel itself is held against the plain
version on the card on the same cases (``cuda`` marker here, and
``chip_smoke.py`` phase 2).  Tolerance: exact — indices and heights must be
equal (NaN matching NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.ops import argmax, argmax_cases
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
    """Every edge case, under the default split and under others, on TMA
    (even O) and cp.async (odd O) copies."""
    for S, O in [(1, 1), (5, 1), (37, 128), (300, 256), (1001, 777),
                 (7501, 5120)]:
        plans = [None]
        if S == 300:
            plans += [argmax.split_plan(S, O, n_splits=2),
                      argmax.split_plan(S, O, n_splits=5),
                      argmax.split_plan(S, O, aligned=False)]
        for plan in plans:
            splits = (plan or argmax.split_plan(S, O)).n_splits
            rng = np.random.default_rng(S + O)
            for case, H, masks in argmax_cases.cases(rng, S, O, splits,
                                                     prefixes=(64, 512)):
                Ht = torch.as_tensor(H, device=cuda_device)
                mt = [torch.as_tensor(m, device=cuda_device) for m in masks]
                before = argmax.launches
                got = argmax.triple_masked_argmax(Ht, *mt, plan=plan)
                assert argmax.launches == before + 1
                want = argmax.triple_masked_argmax_plain(Ht, *mt)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and bool(torch.all(
                        (g == w) | (torch.isnan(g) & torch.isnan(w)))), \
                        (S, O, case)


# ---------------------------------------------------------------------------
# The CUDA kernel's split, modelled in numpy.

_NONE = 2 ** 31 - 1


def _better(a, ia, b, ib):
    """The kernel's order: NaN first, then the larger value, then the
    smaller index (elementwise)."""
    an, bn = np.isnan(a), np.isnan(b)
    return np.where(an | bn, np.where(an & bn, ia < ib, an),
                    (a > b) | ((a == b) & (ia < ib)))


def _merge(best, cand):
    (v, i), (a, ia) = best, cand
    take = _better(a, ia, v, i)
    return np.where(take, a, v), np.where(take, ia, i)


def _kernel_model(H, masks, plan):
    """What the kernel computes under ``plan``, block by block."""
    S, O = H.shape
    T = argmax.TILE_ROWS
    NEG = argmax_cases.NEG
    code = sum(m.astype(np.uint8) << q for q, m in enumerate(masks))
    n_tiles = -(-S // T)
    best = [(np.full(O, -np.inf), np.full(O, _NONE)) for _ in range(3)]
    for sp in range(plan.n_splits):
        starts = range(sp * T, S, plan.n_splits * T)      # the split's tiles
        live = [bool(code[t:t + T].any()) for t in starts]
        assert len(starts) <= argmax.MAX_TILES and sp < n_tiles
        if not any(live):
            # The split's flag: (-1e300, its first row) for every column.
            for q in range(3):
                best[q] = _merge(best[q], (np.full(O, NEG), np.full(O, sp * T)))
            continue
        rows = np.concatenate([np.arange(t, min(t + T, S))
                               for t, ok in zip(starts, live) if ok])
        sel = code[rows]
        Hl = np.full((rows.size, O), NEG)
        Hl[sel != 0] = H[rows[sel != 0]]        # rows in no mask: not read
        dead = [t for t, ok in zip(starts, live) if not ok]
        for q in range(3):
            V = np.where(((sel >> q) & 1).astype(bool)[:, None], Hl, NEG)
            k = np.argmax(V, axis=0)            # first NaN, else first max
            cand = (V[k, np.arange(O)], rows[k])
            if dead:
                cand = _merge(cand, (np.full(O, NEG), np.full(O, dead[0])))
            best[q] = _merge(best[q], cand)
    out = []
    for v, i in best:
        out += [i.astype(np.int64), v]
    return out


_MODEL_SHAPES = [(1, 1), (1, 5), (5, 1), (20, 3), (300, 256), (1001, 777)]
_CASE_NAMES = ["random", "empty", "ties", "nan", "prefix64", "neginf",
               "neg1e300", "nan_unselected", "nan_ties_splits",
               "empty_tile", "empty_split"]


def _named_case(S, O, name, n_splits):
    rng = np.random.default_rng(S * 131 + O)
    for case, H, masks in argmax_cases.cases(rng, S, O, n_splits):
        if case == name:
            return H, [np.asarray(m) for m in masks]
    raise KeyError(name)


def test_split_plan_main_path_shape():
    plan = argmax.split_plan(7501, 5120)
    # One wave of 2 blocks on each of the 132 SMs: 40 O-tiles x 6 splits.
    assert plan.n_otiles == 40 and plan.n_splits == 6
    assert plan.blocks <= 2 * 132
    assert plan.use_tma
    assert plan.workspace_shape(5120) == (6, 3, 5120)


@pytest.mark.parametrize("shape", _MODEL_SHAPES + [(7501, 5120), (10 ** 6, 8)])
def test_split_plan_covers_rows(shape):
    S, O = shape
    plan = argmax.split_plan(S, O)
    n_tiles = -(-S // argmax.TILE_ROWS)
    # Every split has a tile, and no split more than the kernel stages.
    assert 1 <= plan.n_splits <= n_tiles
    assert -(-n_tiles // plan.n_splits) <= argmax.MAX_TILES
    assert plan.n_otiles * argmax.TILE_COLS >= O > \
        (plan.n_otiles - 1) * argmax.TILE_COLS
    # TMA needs a row stride that is a multiple of 16 bytes.
    assert plan.use_tma == (O % 2 == 0)
    assert not argmax.split_plan(S, O, aligned=False).use_tma
    if plan.n_splits == 1:
        assert plan.workspace_shape(O)[0] == 0


@pytest.mark.parametrize("case", _CASE_NAMES)
@pytest.mark.parametrize("shape", _MODEL_SHAPES)
def test_kernel_model_matches_plain_and_xla(shape, case):
    S, O = shape
    plan = argmax.split_plan(S, O)
    H, masks = _named_case(S, O, case, plan.n_splits)
    want = _port(H, masks)
    _assert_same(_kernel_model(H, masks, plan), want)
    _assert_same(want, triple_masked_argmax_xla(
        jnp.asarray(H), *(jnp.asarray(m) for m in masks)))


@pytest.mark.parametrize("n_splits", [1, 2, 5, 10])
def test_kernel_model_other_splits(n_splits):
    """The result does not depend on the split, nor on what H holds in the
    rows no mask selects (the kernel does not read them)."""
    S, O = 300, 130
    plan = argmax.split_plan(S, O, n_splits=n_splits)
    for name in _CASE_NAMES:
        H, masks = _named_case(S, O, name, plan.n_splits)
        want = _port(H, masks)
        _assert_same(_kernel_model(H, masks, plan), want)
        poisoned = H.copy()
        poisoned[~(masks[0] | masks[1] | masks[2])] = np.nan
        _assert_same(_kernel_model(poisoned, masks, plan), want)
