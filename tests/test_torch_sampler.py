"""The port's sampler against the distributions it samples (its draws are
not the JAX package's: the parity tests inject draws instead).

Tolerance: each outcome's empirical frequency within 5 standard errors of
its probability, over 20000 draws from a seeded generator.
"""

import numpy as np
import pytest
import torch

from stochasticdecomposition_torch.sampler import (
    build_sampler, sample_categorical, sample_omega,
)
from stochasticdecomposition_torch.smps.stoc import DIST_DISCRETE
from torch_common import CPU, port_problem

N = 20000


def _within(count, p, n=N):
    se = np.sqrt(p * (1 - p) / n)
    return abs(count / n - p) <= 5 * se + 1e-12


@pytest.mark.parametrize("name", ["lands", "pgp2like"])
def test_discrete_marginals(name):
    sp = port_problem(name)
    spec = build_sampler(sp._stoc, sp.rv_order, CPU)
    gen = torch.Generator().manual_seed(11)
    W = sample_omega(spec, gen, N).numpy()
    for i, el in enumerate(sp._stoc.elements):
        assert el.dist == DIST_DISCRETE
        col = W[:, int(sp.rv_order[i])]
        assert set(np.unique(col)) <= set(el.values)
        for v, p in zip(el.values, el.probs):
            assert _within(int(np.sum(col == v)), p), (i, v)


def test_same_seed_same_draws():
    sp = port_problem("pgp2like")
    spec = build_sampler(sp._stoc, sp.rv_order, CPU)
    a = sample_omega(spec, torch.Generator().manual_seed(3), 50)
    b = sample_omega(spec, torch.Generator().manual_seed(3), 50)
    assert torch.equal(a, b)


def test_bootstrap_categorical():
    probs = torch.tensor([0.5, 0.0, 0.3, 0.2, 0.0], dtype=torch.float64)
    d = sample_categorical(torch.Generator().manual_seed(5), probs, 4, N // 4)
    assert d.shape == (4, N // 4)
    counts = np.bincount(d.numpy().ravel(), minlength=5)
    for j, p in enumerate(probs.tolist()):
        assert _within(int(counts[j]), p)
