"""The CUDA triple masked argmax against its plain PyTorch version, on the
card.  This file imports nothing of JAX, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_argmax_cuda.py -q

Every edge case of ``ops/argmax_cases.py`` (pool prefixes of 64 and 512
rows, selected -inf and -1e300, NaN in selected and unselected rows, ties
across split boundaries, an empty tile and an empty split), under the
default split and, at (300, 256), under 2 and 5 S-splits and with cp.async
copies (odd O takes them always); also at one obs rank's columns of the
default table over 2 and 4 ranks, and at a width that splits oddly.
Tolerance: exact — indices and heights
equal, NaN matching NaN; one launch counted per call.  Without a card the
test is skipped.
"""

import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.ops import argmax, argmax_cases

SHAPES = [(1, 1), (5, 1), (37, 128), (300, 256), (1001, 777), (7501, 5120),
          (7501, 2560), (7501, 1280), (7501, 2561)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain(cuda_device, shape):
    S, O = shape
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
                    (S, O, case, plan)
