"""Several processes, one per card, joined by ``torch.distributed``.

The port of the JAX package's ``parallel/distributed.py``.  A run over
several cards is one process (rank) per card; the ranks join one process
group, and the replication runner (``parallel/runner.py``) gives each rep
group's lead rank its replications.  The compromise and the result files
stay on rank 0, the coordinator (compromise.c:249-311 gathers to one
aggregation point).

The collectives carry host data only: ``ReplicationResult``s (their
``BatchEntry`` is host copies already), done and error flags, and the
evaluation's per-lane objectives.  No device tensor crosses ranks, so the
group's backend is ``gloo``: it works for ranks that share one card and
across nodes alike.

Two timeouts.  Joining the group waits at most ``JOIN_TIMEOUT`` for the
other ranks, so a missing peer fails instead of hanging.  The runner's
collectives then wait for whole waves of replications, hours at storm
scale, so they go through a second group with ``WAVE_TIMEOUT``; a peer
process that dies closes its sockets, and the others fail at once.  A peer
that hangs without dying (a stuck card, an endless loop) holds the others
in the gather until ``WAVE_TIMEOUT``: what bounds such a run is the time
limit of whatever launches it (``timeout`` around ``torchrun``, the job
scheduler's wall-clock limit).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from stochasticdecomposition_torch.device import resolve_device

JOIN_TIMEOUT = timedelta(minutes=5)
WAVE_TIMEOUT = timedelta(days=7)

_wave_group = None


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
