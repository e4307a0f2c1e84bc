"""The (rep, obs) mesh over the ranks of a ``torch.distributed`` run.

The port of the JAX package's ``parallel/mesh.py``.  There, a GSPMD mesh of
devices has two axes: ``rep`` carries one replication per device group and
``obs`` shards that replication's pools (omega, the delta tables, the cut
iStar records) across the group's devices.  Here a mesh lays the ranks
(one process per card, ``parallel/distributed.py``) out as
``rank = rep_coord * n_obs + obs_coord``:

  * ``rep``: in each wave of ``n_rep`` replications, the ranks of rep group
    ``g`` run replication ``wave_start + g`` (``parallel/runner.py``);
  * ``obs``: those ``n_obs`` ranks step that replication in lockstep, and
    rank ``(g, j)`` holds only the observation columns
    ``obs_block(O) = [j O / n_obs, (j + 1) O / n_obs)`` of its
    ``omega_vals``, ``omega_w``, ``delta_pib``, ``delta_piC`` and
    ``cut_istar`` (the JAX package's ``_FIELD_SPECS``); the rest of the
    state is replicated work, computed alike on every rank, as GSPMD does
    for replicated values.  Every sum over observations is a partial sum
    per rank plus a sum over the group's obs ranks, every first match a
    minimum (``parallel/distributed.py``'s ``obs_*`` collectives over the
    group ``make_mesh`` builds).  Each rank launches the argmax kernel on
    its own columns of the height table.

Ranks past ``n_rep * n_obs`` join the collectives and take no replication.
The evaluations run on rank 0.  ``make_sharded_eval`` splits one
evaluation batch's lanes across every rank of the world; it is a library
function for callers that drive every rank themselves, and the run path
does not use it.

The JAX module's ``state_shardings``, ``make_multi_rep_step`` and
``init_multi_rep_state`` annotate a stacked state for XLA's partitioner;
they have no PyTorch counterpart: each rank steps its own shard of its
replication's state with the sequential step (``core/``), which reads the
shard from ``SDState.shard``, and ``all_gather`` of the host results takes
the place of the replicated outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stochasticdecomposition_torch.core.evaluate import (
    batch_stats, make_eval_batch,
)
from stochasticdecomposition_torch.parallel.distributed import (
    ObsShard, all_gather, new_obs_groups, process_count, process_index,
)
from stochasticdecomposition_torch.sampler import sample_omega


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_rep: int
    n_obs: int
    world: int
    rank: int
    # This rank's rep group's obs ranks (None with n_obs 1 or past the mesh).
    obs_group: object = dataclasses.field(default=None, compare=False,
                                          repr=False)

    def coords(self, rank: Optional[int] = None):
        """(rep_coord, obs_coord) of ``rank`` (this one by default), or
        None for a rank past ``n_rep * n_obs``."""
        rank = self.rank if rank is None else rank
        if rank >= self.n_rep * self.n_obs:
            return None
        return divmod(rank, self.n_obs)

    def lead_rank(self, rep: int) -> int:
        """The rank that runs replication ``rep``: its rep group's
        ``(g, 0)``, g = rep mod n_rep."""
        return (rep % self.n_rep) * self.n_obs

    def obs_block(self, O: int) -> tuple:
        """(lo, hi): the observation columns of the O a replication holds
        that this rank owns (the first block past the mesh).  Raises
        ValueError unless ``n_obs`` divides O, as the JAX package's
        runner does."""
        if O % self.n_obs:
            raise ValueError(
                f"omega capacity {O} not divisible by the obs mesh axis "
                f"{self.n_obs}; choose MAX_OMEGA so that it is")
        per = O // self.n_obs
        coords = self.coords()
        j = 0 if coords is None else coords[1]
        return j * per, (j + 1) * per

    def obs_shard(self, O: int) -> Optional[ObsShard]:
        """This rank's shard of a replication with O observation columns,
        or None where it holds them all (``n_obs`` 1) or takes no
        replication; raises as ``obs_block``."""
        lo, hi = self.obs_block(O)
        if self.n_obs == 1 or self.coords() is None:
            return None
        return ObsShard(lo, hi, self.n_obs, self.obs_group)


def make_mesh(n_rep: int = 1, n_obs: Optional[int] = None) -> Mesh:
    """The mesh over the world's ranks (one rank when no process group is
    initialized).  ``n_obs`` defaults to ``world // n_rep``; raises
    ValueError unless ``n_rep * n_obs <= world``.  With ``n_obs`` above 1
    it builds the rep groups' obs process groups: every rank of the world
    calls it, with the same shape."""
    world = process_count()
    if n_obs is None:
        n_obs = world // n_rep
    if n_rep < 1 or n_obs < 1 or n_rep * n_obs > world:
        raise ValueError(
            f"mesh {n_rep}x{n_obs} needs {n_rep}*{n_obs} <= {world} ranks "
            "(one process per card; launch with torchrun and --distributed)")
    group = new_obs_groups(n_rep, n_obs) if n_obs > 1 else None
    return Mesh(n_rep, n_obs, world, process_index(), group)


def make_sharded_eval(pa, spec, batch: int, mesh: Mesh):
    """``fn(x, gen=None, w_raw=None) -> (mean, M2, n_ok, n)`` over one batch
    of ``batch`` observations split across the world's ranks: the contract
    of ``core/evaluate.make_eval_batch``, so that ``evaluate`` takes it.
    Every rank calls it at once.

    Every rank draws the same full batch from ``gen`` (seeded alike on every
    rank) or takes the injected ``w_raw``, solves its contiguous
    ``batch / world`` lanes warm from the mean observation's basis, gathers
    every rank's (objs, ok) in lane order and reduces them with
    ``batch_stats``, as ``make_eval_batch`` does.  Replaces the sequential
    evaluate loop (evaluate.c:49-103)."""
    if batch % mesh.world:
        raise ValueError(
            f"sharded evaluation batch {batch} is not a multiple of the "
            f"{mesh.world} ranks")
    per = batch // mesh.world
    local = make_eval_batch(pa, spec, per)
    lo = mesh.rank * per

    def eval_batch(x, gen=None, w_raw=None):
        if w_raw is None:
            w_raw = sample_omega(spec, gen, batch, dtype=pa.c1.dtype)
        if w_raw.shape[0] != batch:
            raise ValueError(
                f"w_raw holds {w_raw.shape[0]} observations, not {batch}")
        objs, ok = local.solve_lanes(x, w_raw[lo:lo + per])
        parts = all_gather((objs.cpu().numpy(), ok.cpu().numpy()))
        dev = pa.c1.device
        objs = torch.as_tensor(np.concatenate([p[0] for p in parts]),
                               device=dev)
        ok = torch.as_tensor(np.concatenate([p[1] for p in parts]),
                             device=dev)
        return (*batch_stats(objs, ok), batch)

    return eval_batch
