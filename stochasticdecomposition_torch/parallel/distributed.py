"""Several processes, one per card, joined by ``torch.distributed``.

The port of the JAX package's ``parallel/distributed.py``.  A run over
several cards is one process (rank) per card; the ranks join one process
group, and the replication runner (``parallel/runner.py``) gives each rep
group its replications.  The compromise and the result files stay on rank
0, the coordinator (compromise.c:249-311 gathers to one aggregation point).

Two kinds of collectives, both on ``gloo``:

  * between replications, host data: ``ReplicationResult``s (their
    ``BatchEntry`` is host copies already), done and error flags, and the
    evaluation's per-lane objectives (``all_gather``);
  * inside one replication whose pools are sharded over the ranks of its
    rep group (``ObsShard``), small tensors: the partial sums of a cut,
    first matches, the bootstrap's weights, stored observations
    (``obs_sum``, ``obs_min``, ``obs_max``).  They are staged through the host:
    the ranks of one card's run share it, and NCCL refuses two ranks on
    one device, while ``gloo`` takes host tensors on any layout; on
    separate cards the same ``gloo`` group works unchanged (a few scalars
    and [n1] vectors per cut, not worth an NCCL group).  ``obs_sum`` sums
    the gathered parts in rank order on the host, so that every rank of
    the group holds the same bits and takes the same decisions.
    ``obs_seconds`` and ``obs_calls`` count their wall time (the host
    staging included) and their calls in this process.

Three timeouts.  Joining the group waits at most ``JOIN_TIMEOUT`` for the
other ranks, so a missing peer fails instead of hanging.  The runner's
collectives then wait for whole waves of replications, hours at storm
scale, so they go through a second group with ``WAVE_TIMEOUT``; a peer
process that dies closes its sockets, and the others fail at once.  A peer
that hangs without dying (a stuck card, an endless loop) holds the others
in the gather until ``WAVE_TIMEOUT``: what bounds such a run is the time
limit of whatever launches it (``timeout`` around ``torchrun``, the job
scheduler's wall-clock limit).  The obs groups' collectives come every
step, between the same replicated work on every rank, so they wait at
most ``OBS_TIMEOUT``: a rank that failed alone, outside a collective,
leaves its peers waiting that long before they fail too.

Every rank leaves the groups it joined through ``shutdown`` (the CLI, the
rank entries of ``chip_smoke.py``, the test workers): a process that exits
with its groups alive can abort in the interpreter's exit (SIGABRT) after
a correct run.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from stochasticdecomposition_torch.device import resolve_device

JOIN_TIMEOUT = timedelta(minutes=5)
WAVE_TIMEOUT = timedelta(days=7)
OBS_TIMEOUT = timedelta(minutes=30)

_wave_group = None
_obs_groups = {}

# Wall seconds and calls of the obs collectives in this process; a caller
# that reads them sets them to 0 first.
obs_seconds = 0.0
obs_calls = 0


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the process group when a multi-process run is configured.

    The coordinates come from the arguments or, when omitted, from the
    environment: the JAX package's names (``COORDINATOR_ADDRESS`` as
    ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``) first, then
    torchrun's (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``coordinator_address`` may also be a URL (``tcp://``, ``file://``).
    Returns True when the group is initialized, False when nothing is
    configured (one process).  Safe to call more than once."""
    global _wave_group
    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        n = env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None
    if addr is None and num_processes is None:
        return False
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator address, the number "
            f"of processes and this process's id (got {addr!r}, "
            f"{num_processes!r}, {process_id!r})")
    dist.init_process_group(
        "gloo", init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id, timeout=JOIN_TIMEOUT)
    _wave_group = dist.new_group(backend="gloo", timeout=WAVE_TIMEOUT)
    return True


def shutdown(barrier: bool = True) -> None:
    """Leave the process group that ``maybe_initialize`` joined: every rank
    meets the others at a barrier on the wave group, then destroys the obs
    groups, the wave group and the default group, in that order, and
    forgets them.  A rank that leaves its groups to the interpreter's exit
    can abort there (SIGABRT, ``terminate called without an active
    exception``) after a correct run.  Every rank calls it on its way out;
    safe to call twice, and nothing to do in one process.

    ``barrier=False`` is the way out of a rank that raised: its peers may
    wait in another collective, and the rank destroys its groups at once,
    which fails them as its death would, instead of waiting for them."""
    global _wave_group
    if not dist.is_initialized():
        return
    if barrier:
        dist.barrier(group=_wave_group)
    for group in _obs_groups.values():
        if group is not None:
            dist.destroy_process_group(group)
    _obs_groups.clear()
    if _wave_group is not None:
        dist.destroy_process_group(_wave_group)
    _wave_group = None
    dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the rank that owns the host epilogues (the evaluation of the
    replications, the compromise, the result files); True in one process."""
    return process_index() == 0


def all_gather(obj) -> list:
    """Every rank's ``obj`` (picklable host data), in rank order, on every
    rank."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_wave_group)
    return out


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as ``resolve_device`` takes it, the
    CUDA card unless the CPU is asked for.  A card without an index is
    card ``LOCAL_RANK % device_count`` (torchrun's LOCAL_RANK, else the
    rank), so that several ranks can share one card; it becomes the
    current card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_index()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def new_obs_groups(n_rep: int, n_obs: int):
    """One ``gloo`` group per rep group, over its ``n_obs`` ranks
    ``g * n_obs ... (g + 1) * n_obs - 1``; returns this rank's (None past
    the mesh).  Every rank of the world calls it, with the same shape; the
    groups of a shape are built once per process group."""
    key = (id(_wave_group), n_rep, n_obs)
    if key not in _obs_groups:
        mine = None
        for g in range(n_rep):
            ranks = list(range(g * n_obs, (g + 1) * n_obs))
            group = dist.new_group(ranks=ranks, backend="gloo",
                                   timeout=OBS_TIMEOUT)
            if process_index() in ranks:
                mine = group
        _obs_groups[key] = mine
    return _obs_groups[key]


@dataclasses.dataclass(frozen=True)
class ObsShard:
    """A rank's block of one replication's observation columns: the global
    columns ``[lo, hi)`` of its pools (the block layout of the JAX
    package's ``P("obs")``), the ``n_obs`` ranks of its rep group that hold
    the others, and their process group.  A state without one (``None``)
    holds every column, and the collectives below are the identity."""
    lo: int
    hi: int
    n_obs: int
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)


def _combined(t: torch.Tensor, shard: ObsShard, combine) -> torch.Tensor:
    """``combine`` of every obs rank's ``t`` (same shape and dtype),
    gathered in obs order on the host, back on ``t``'s device."""
    global obs_seconds, obs_calls
    t0 = time.perf_counter()
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(shard.n_obs)]
    dist.all_gather(parts, host, group=shard.group)
    out = combine(parts).to(t.device)
    obs_seconds += time.perf_counter() - t0
    obs_calls += 1
    return out


def _in_order(parts: list) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def obs_sum(t: torch.Tensor, shard: Optional[ObsShard]) -> torch.Tensor:
    """The sum of ``t`` over the obs ranks, added in obs order (the same
    bits on every rank).  A row that one rank holds and the others pass
    as zeros reaches every rank as its owner's."""
    if shard is None:
        return t
    return _combined(t, shard, _in_order)


def obs_min(t: torch.Tensor, shard: Optional[ObsShard]) -> torch.Tensor:
    """The elementwise minimum of ``t`` over the obs ranks."""
    if shard is None:
        return t
    return _combined(t, shard, lambda parts: torch.stack(parts).amin(0))


def obs_max(t: torch.Tensor, shard: Optional[ObsShard]) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the obs ranks."""
    if shard is None:
        return t
    return _combined(t, shard, lambda parts: torch.stack(parts).amax(0))
