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


# A two-row second stage with a joint (BLOCKS) and an INDEP normal/uniform
# stoch file: the texts of tests/test_distributions.py, copied.
_CORE = """NAME          BLK
ROWS
 N  OBJ
 G  R1A
 G  R2A
 G  R2B
COLUMNS
    X1        OBJ       2.0    R1A       1.0
    X1        R2A       -0.5
    X2        OBJ       1.5    R1A       1.0
    X2        R2B       -0.5
    Y1        OBJ       3.0    R2A       1.0
    Y2        OBJ       2.0    R2B       1.0
    S1        OBJ       40.0   R2A       1.0
    S2        OBJ       40.0   R2B       1.0
RHS
    RHS       R1A       2.0    R2A       3.0
    RHS       R2B       2.0
ENDATA
"""

_TIME = """TIME          BLK
PERIODS       IMPLICIT
    X1        R1A       STAGE1
    Y1        R2A       STAGE2
ENDATA
"""

_STOC_BLOCKS = """STOCH         BLK
BLOCKS        DISCRETE
 BL B1        STAGE2    0.4
    RHS       R2A       2.0
    RHS       R2B       1.0
 BL B1        STAGE2    0.6
    RHS       R2A       4.0
    RHS       R2B       3.0
ENDATA
"""

_STOC_NORMAL = """STOCH         BLK
INDEP         NORMAL
    RHS       R2A       3.0    STAGE2    0.25
INDEP         UNIFORM
    RHS       R2B       1.0    STAGE2    3.0
ENDATA
"""


def _draws(stoc_text, tmp_path, seed):
    """N raw observations of the parsed stoch text, columns in the stoch
    file's element order (R2A, R2B)."""
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.smps import (
        read_core, read_stoc, read_time,
    )

    paths = [tmp_path / n for n in ("b.cor", "b.tim", "b.sto")]
    for p, text in zip(paths, (_CORE, _TIME, stoc_text)):
        p.write_text(text)
    core = read_core(str(paths[0]))
    stoc = read_stoc(str(paths[2]), core)
    sp = attach_stoc(decompose(core, read_time(str(paths[1]), core), stoc),
                     stoc)
    spec = build_sampler(stoc, sp.rv_order, CPU)
    W = sample_omega(spec, torch.Generator().manual_seed(seed), N).numpy()
    return W[:, np.asarray(sp.rv_order)]


def test_normal_mean_and_variance(tmp_path):
    x = _draws(_STOC_NORMAL, tmp_path, 21)[:, 0]
    mean, var = 3.0, 0.25              # the stoch file gives the variance
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / N)
    # The sample variance of a normal has variance 2 var^2 / (N - 1).
    assert abs(x.var(ddof=1) - var) <= 5 * np.sqrt(2 * var ** 2 / (N - 1))


def test_uniform_range_and_mean(tmp_path):
    x = _draws(_STOC_NORMAL, tmp_path, 22)[:, 1]
    lo, hi = 1.0, 3.0
    assert x.min() >= lo and x.max() <= hi
    # Spread over the whole range, not a point or a sub-interval.
    assert x.min() < lo + 0.01 and x.max() > hi - 0.01
    sd = (hi - lo) / np.sqrt(12.0)
    assert abs(x.mean() - (lo + hi) / 2) <= 5 * sd / np.sqrt(N)


def test_blocks_joint_outcomes(tmp_path):
    W = _draws(_STOC_BLOCKS, tmp_path, 23)
    # The members move together: only the two joint outcomes occur.
    low = (W[:, 0] == 2.0) & (W[:, 1] == 1.0)
    high = (W[:, 0] == 4.0) & (W[:, 1] == 3.0)
    assert np.all(low | high)
    assert _within(int(np.sum(low)), 0.4)
    assert _within(int(np.sum(high)), 0.6)
