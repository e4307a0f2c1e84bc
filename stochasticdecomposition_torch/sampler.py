"""Scenario sampler: ``generateOmega`` (reference: algo.c:145) on a
``torch.Generator``.

The distributions (INDEP discrete/normal/uniform + BLOCKS discrete) are
staged into padded tables and sampled by inverse-cdf lookup.  The draws come
from the caller's generator, one per replication, so a run is reproducible
from its seed; they are not the JAX package's bit-stream (tests inject the
same draws into both packages instead).

The omega vector layout follows the reference's rvOffset convention
(subprob.c:107-110,141): [ b-block | C-block | d-block ], mean-UNcentered.
Mean-centering happens in the algorithm loop (algo.c:148-149).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stochasticdecomposition_torch.smps.stoc import (
    DIST_BLOCK, DIST_DISCRETE, DIST_NORMAL, DIST_UNIFORM, StocData,
)


class SamplerSpec(NamedTuple):
    """Padded distribution tables as tensors on the run's device."""

    num_rv: int
    # INDEP DISCRETE: for each such RV, support and cdf (padded to max size).
    disc_pos: torch.Tensor       # [n_disc] positions in the omega vector
    disc_vals: torch.Tensor      # [n_disc, S]
    disc_cdf: torch.Tensor       # [n_disc, S] inclusive cdf, padded with 1.0
    # INDEP NORMAL.
    norm_pos: torch.Tensor       # [n_norm]
    norm_mean: torch.Tensor
    norm_std: torch.Tensor
    # INDEP UNIFORM.
    unif_pos: torch.Tensor       # [n_unif]
    unif_lo: torch.Tensor
    unif_hi: torch.Tensor
    # BLOCKS DISCRETE: joint outcomes scattered to member positions.
    blk_cdf: torch.Tensor        # [n_blk, O] inclusive cdf padded with 1.0
    blk_pos: torch.Tensor        # [n_blk, M] member positions (pad: 0)
    blk_mask: torch.Tensor       # [n_blk, M] member validity
    blk_vals: torch.Tensor       # [n_blk, O, M]


def build_sampler(stoc: StocData, rv_order: np.ndarray,
                  device: torch.device) -> SamplerSpec:
    """Stage a parsed stoch file into padded sampling tables.

    ``rv_order[i]`` is the omega-vector position of parsed element i (the
    [b|C|d] grouping permutation computed by prob.decompose).
    """
    disc, norm, unif = [], [], []
    for i, el in enumerate(stoc.elements):
        pos = int(rv_order[i])
        if el.dist == DIST_DISCRETE:
            disc.append((pos, el.values, el.probs))
        elif el.dist == DIST_NORMAL:
            norm.append((pos, el.p1, el.p2))
        elif el.dist == DIST_UNIFORM:
            unif.append((pos, el.p1, el.p2))
        elif el.dist == DIST_BLOCK:
            pass   # handled through stoc.blocks
        else:
            raise ValueError(el.dist)

    S = max([len(v) for _, v, _ in disc], default=1)
    n_disc = len(disc)
    disc_pos = np.zeros(n_disc, np.int64)
    disc_vals = np.zeros((n_disc, S))
    disc_cdf = np.ones((n_disc, S))
    for k, (pos, vals, probs) in enumerate(disc):
        disc_pos[k] = pos
        disc_vals[k, :len(vals)] = vals
        disc_vals[k, len(vals):] = vals[-1]
        disc_cdf[k, :len(probs)] = np.cumsum(probs)

    n_blk = len(stoc.blocks)
    O = max([len(b.probs) for b in stoc.blocks], default=1)
    M = max([len(b.elem_indices) for b in stoc.blocks], default=1)
    blk_cdf = np.ones((n_blk, O))
    blk_pos = np.zeros((n_blk, M), np.int64)
    blk_mask = np.zeros((n_blk, M), bool)
    blk_vals = np.zeros((n_blk, O, M))
    for k, b in enumerate(stoc.blocks):
        no, nm = len(b.probs), len(b.elem_indices)
        blk_cdf[k, :no] = np.cumsum(b.probs)
        blk_pos[k, :nm] = rv_order[np.asarray(b.elem_indices)]
        blk_mask[k, :nm] = True
        blk_vals[k, :no, :nm] = b.outcomes
        blk_vals[k, no:, :nm] = b.outcomes[-1]

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    i64 = torch.int64
    return SamplerSpec(
        num_rv=len(stoc.elements),
        disc_pos=t(disc_pos, i64), disc_vals=t(disc_vals),
        disc_cdf=t(disc_cdf),
        norm_pos=t(np.array([p for p, _, _ in norm], np.int64), i64),
        norm_mean=t(np.array([m for _, m, _ in norm])),
        norm_std=t(np.sqrt(np.array([v for _, _, v in norm]))),
        unif_pos=t(np.array([p for p, _, _ in unif], np.int64), i64),
        unif_lo=t(np.array([lo for _, lo, _ in unif])),
        unif_hi=t(np.array([hi for _, _, hi in unif])),
        blk_cdf=t(blk_cdf), blk_pos=t(blk_pos, i64),
        blk_mask=t(blk_mask, torch.bool), blk_vals=t(blk_vals),
    )


def _inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """First support index whose inclusive cdf reaches u: [n, k]."""
    idx = torch.sum(u[:, :, None] > cdf[None, :, :], dim=-1)
    return torch.clamp(idx, 0, cdf.shape[1] - 1)


def sample_omega(spec: SamplerSpec, gen: torch.Generator, n: int,
                 dtype=torch.float64) -> torch.Tensor:
    """Draw ``n`` raw (uncentered) observation vectors, shape [n, num_rv]."""
    dev = spec.disc_vals.device
    out = torch.zeros((n, spec.num_rv), dtype=dtype, device=dev)

    def uniform(k):
        return torch.rand((n, k), generator=gen, dtype=torch.float64,
                          device=dev)

    n_disc = spec.disc_pos.shape[0]
    if n_disc:
        idx = _inverse_cdf(spec.disc_cdf, uniform(n_disc))
        vals = torch.gather(spec.disc_vals.expand(n, -1, -1), 2,
                            idx[:, :, None])[..., 0]
        out[:, spec.disc_pos] = vals.to(dtype)

    if spec.norm_pos.shape[0]:
        z = torch.randn((n, spec.norm_pos.shape[0]), generator=gen,
                        dtype=torch.float64, device=dev)
        out[:, spec.norm_pos] = (spec.norm_mean[None] +
                                 spec.norm_std[None] * z).to(dtype)

    if spec.unif_pos.shape[0]:
        u = uniform(spec.unif_pos.shape[0])
        out[:, spec.unif_pos] = (spec.unif_lo[None] + (
            spec.unif_hi - spec.unif_lo)[None] * u).to(dtype)

    n_blk = spec.blk_cdf.shape[0]
    if n_blk:
        idx = _inverse_cdf(spec.blk_cdf, uniform(n_blk))
        M = spec.blk_vals.shape[2]
        chosen = torch.gather(spec.blk_vals.expand(n, -1, -1, -1), 2,
                              idx[:, :, None, None].expand(-1, -1, 1, M)
                              )[:, :, 0, :]                   # [n, n_blk, M]
        flat_mask = spec.blk_mask.reshape(-1)
        safe_pos = torch.where(flat_mask, spec.blk_pos.reshape(-1), 0)
        contrib = torch.where(flat_mask, chosen.reshape(n, -1), 0.0)
        out.index_add_(1, safe_pos, contrib.to(dtype))

    return out


def sample_categorical(gen: torch.Generator, probs: torch.Tensor,
                       reps: int, n: int) -> torch.Tensor:
    """``reps`` rows of ``n`` iid draws from the categorical ``probs`` [O]
    (the bootstrap's resampling of the empirical distribution): [reps, n]."""
    if n == 0:
        return torch.zeros((reps, 0), dtype=torch.int64, device=probs.device)
    return torch.multinomial(probs.expand(reps, -1), n, replacement=True,
                             generator=gen)
