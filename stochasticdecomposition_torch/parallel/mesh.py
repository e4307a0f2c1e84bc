"""The (rep, obs) mesh over the ranks of a ``torch.distributed`` run.

The port of the JAX package's ``parallel/mesh.py``.  There, a GSPMD mesh of
devices has two axes: ``rep`` carries one replication per device group and
``obs`` shards that replication's pools (omega, the delta tables, the cut
iStar records) across the group's devices.  Here a mesh lays the ranks
(one process per card, ``parallel/distributed.py``) out as
``rank = rep_coord * n_obs + obs_coord``:

  * ``rep``: in each wave of ``n_rep`` replications, rep group ``g``'s lead
    rank ``(g, 0)`` runs replication ``wave_start + g`` whole
    (``parallel/runner.py``);
  * ``obs``: one replication's SD pools are not split across cards: one
    H100 holds a replication at the default capacities whole
    (H[7501, 5120] is 307 MB), so the ranks with ``obs_coord > 0`` take no
    SD work.  Sharding the pools is ROADMAP's row for configurations whose
    pools exceed one card.

Ranks past ``n_rep * n_obs`` join the collectives and take no replication.
So in ``SDSolver.run(mesh=)`` and the CLI's ``--mesh RxO`` an ``O`` above
1 only adds ranks that wait in the gathers, as the JAX package's run path
does once its pools are sharded; the evaluations run on rank 0.
``make_sharded_eval`` splits one evaluation batch's lanes across every
rank of the world; it is a library function for callers that drive every
rank themselves, and the run path does not use it.

The JAX module's ``state_shardings``, ``make_multi_rep_step`` and
``init_multi_rep_state`` annotate a stacked state for XLA's partitioner;
they have no PyTorch counterpart.  Each lead rank steps its replication's
own state with the sequential step, and ``all_gather`` of the host results
takes the place of the replicated outputs.
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
    all_gather, process_count, process_index,
)
from stochasticdecomposition_torch.sampler import sample_omega


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_rep: int
    n_obs: int
    world: int
    rank: int

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


def make_mesh(n_rep: int = 1, n_obs: Optional[int] = None) -> Mesh:
    """The mesh over the world's ranks (one rank when no process group is
    initialized).  ``n_obs`` defaults to ``world // n_rep``; raises
    ValueError unless ``n_rep * n_obs <= world``."""
    world = process_count()
    if n_obs is None:
        n_obs = world // n_rep
    if n_rep < 1 or n_obs < 1 or n_rep * n_obs > world:
        raise ValueError(
            f"mesh {n_rep}x{n_obs} needs {n_rep}*{n_obs} <= {world} ranks "
            "(one process per card; launch with torchrun and --distributed)")
    return Mesh(n_rep, n_obs, world, process_index())


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
