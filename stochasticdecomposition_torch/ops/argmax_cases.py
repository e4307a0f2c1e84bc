"""Inputs of the triple masked argmax that reach its edge cases.

numpy only, made from a seeded generator; the tests and ``chip_smoke.py``
feed them to the kernel (or, on the CPU, to a model of its split) and to the
plain version, which must agree exactly.  ``n_splits`` is the split plan's
number of S-splits, which take the row tiles in turn: every tile boundary is
a boundary between two splits.
"""

from __future__ import annotations

import numpy as np

NEG = -1e300
TILE_ROWS = 32     # the kernel's rows per ring stage (ops/argmax.py)


def prefix_masks(S: int, n: int):
    """The main path's masks: the first n rows are the sigma pool, "old"
    the first three quarters of it and "new" the rest (sigma_ck grows with
    the row index)."""
    s = np.arange(S)
    base = s < n
    old = s < n - n // 4
    return base, old, base & ~old


def random_masks(rng, S: int, probs=(0.9, 0.5, 0.3)):
    return [rng.random(S) < p for p in probs]


def cases(rng, S: int, O: int, n_splits: int, prefixes=(64,)):
    """Yields (name, H [S, O] f64, [base, old, new] bool [S])."""
    s = np.arange(S)
    H = rng.standard_normal((S, O)) * 100.0
    masks = random_masks(rng, S)
    yield "random", H, masks

    none = np.zeros(S, bool)
    yield "empty", H, [none, masks[1], none]
    yield "ties", np.full((S, O), 3.25), [np.ones(S, bool), masks[1],
                                          masks[2]]
    Hn = H.copy()
    Hn[S // 2, :] = np.nan
    Hn[S // 3, ::2] = np.nan
    yield "nan", Hn, masks

    for n in prefixes:
        yield f"prefix{n}", H, list(prefix_masks(S, min(n, S)))

    # A selected -inf: an unselected row's -1e300 beats it; with every row
    # selected the first -inf wins.
    Hi = H.copy()
    Hi[:, ::3] = -np.inf
    yield "neginf", Hi, [np.ones(S, bool), masks[1], masks[2]]

    # Selected entries exactly -1e300 tie with the unselected rows: the
    # smallest index among both wins, selected or not.
    He = np.full((S, O), -np.inf)
    He[s % 7 == 3, 0::2] = NEG
    He[:, 1::4] = NEG
    yield "neg1e300", He, masks

    # NaN in the rows no mask selects must not win; NaN in rows only "new"
    # selects wins for "all" and "new" but not for "old".
    base = rng.random(S) < 0.6
    old = base & (rng.random(S) < 0.5)
    new = base & ~old
    Hu = H.copy()
    Hu[~base, :] = np.nan
    Hu[new, 1::2] = np.nan
    yield "nan_unselected", Hu, [base, old, new]

    # Ties everywhere (three integer values) and NaN in selected rows on
    # both sides of split boundaries: the first NaN, else the first maximum.
    Ht = rng.integers(0, 3, size=(S, O)).astype(np.float64)
    m = [x.copy() for x in masks]
    T = TILE_ROWS
    for r, cols in ((T - 1, slice(0, None, 4)), (T, slice(0, None, 2)),
                    (2 * T + 5, slice(1, None, 4)),
                    (n_splits * T + 3, slice(3, None, 4)),
                    (3 * T - 1, slice(3, None, 4))):
        if r < S:
            Ht[r, cols] = np.nan
            for x in m:
                x[r] = True
    yield "nan_ties_splits", Ht, m

    # A row tile, and every tile of one split, that no mask selects, with
    # -inf in the selected rows of half the columns: there the skipped
    # tile's (or split's) first row wins with -1e300.
    tile = s // TILE_ROWS
    for name, dead in (("empty_tile", tile == 1),
                       ("empty_split", tile % n_splits == 1 % n_splits)):
        base = ~dead
        old = base & (rng.random(S) < 0.5)
        Hx = H.copy()
        Hx[:, ::2] = -np.inf
        yield name, Hx, [base, old, base & ~old]
