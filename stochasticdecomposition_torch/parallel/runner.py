"""Replications over the ranks of a mesh, in waves.

The port of the JAX package's ``parallel/runner.py``.  The reference runs
replications one after another in one process (algo.c:36-76).  Here the
MULTIPLE_REP replications run in waves of the mesh's ``n_rep``: in the wave
that starts at replication ``wave_start``, every rank of rep group ``g``
runs replication ``wave_start + g`` through ``SDSolver.solve_replication``,
with its own RUN_SEED generators (seeded alike on each of the group's
ranks), feasibility handling, master-failure rule and pool-overflow check,
so that every replication is the sequential path's (bit for bit on the
same kind of device without obs sharding; within the last bits of the
sums over observations with it).  With ``n_obs`` above 1 the group's ranks
hold its observation columns in blocks (``Mesh.obs_shard``) and step in
lockstep, combining their columns in the obs collectives of
``parallel/distributed.py``.  A short final wave leaves the last groups
idle.  After each wave every rank gathers the wave's results, taken from
each group's obs rank 0, so that every rank returns the same
``ReplicationResult`` list in replication order.

A failure on one rank must not leave the others waiting in the gather: a
rank that fails gathers its error text instead of a result, and then every
rank raises the same RuntimeError naming the replication.

Checkpoints (``checkpoint_every``, ``checkpoint_dir``): the lead rank of
each rep group, its obs rank 0, writes that replication's files
(``utils/checkpoint.wave_path``); with ``n_obs`` above 1 the group's ranks
save at the same k and obs rank 0 gathers their blocks of the observation
columns into the one file, at the full width.  The JAX package saves a
wave's stacked state from one process and refuses to checkpoint across
processes; here every mesh of more than one rank is several processes,
hence files per replication.  ``resume_from`` names any file of a wave: the
waves before it are rebuilt from their replications' ``_final`` files; each
replication of that wave is rebuilt from its ``_final`` file if it has one,
else resumes from its newest checkpoint in that directory, else starts
afresh; the waves after it run.  A file holds every observation column, so
it resumes on a mesh of any ``n_obs``: each rank keeps its block.  Every
rank reads the files of every lead rank, so checkpoints and resume over
several nodes need a ``checkpoint_dir`` that all the ranks share.  Random
cost coefficients run sharded too (``core/randcost.py``).
"""

from __future__ import annotations

import os
import traceback
from typing import List

from stochasticdecomposition_torch.parallel.distributed import all_gather
from stochasticdecomposition_torch.utils.checkpoint import (
    newest_wave_checkpoint, wave_path, wave_start_of,
)


def run_replications_meshed(solver, mesh, log=lambda s: None,
                            checkpoint_every: int = 0,
                            checkpoint_dir: str | None = None,
                            resume_from: str | None = None) -> List:
    """Every replication of ``solver.cfg`` over ``mesh``; see the module
    docstring.  Every rank of the mesh calls it."""
    R = solver.cfg.MULTIPLE_REP
    W = mesh.n_rep
    coords = mesh.coords()
    group = None if coords is None else coords[0]
    # Every rank refuses an O its obs ranks do not divide, before any work.
    shard = mesh.obs_shard(solver.caps.O)
    resume_wave, resume_dir = -1, None
    if resume_from:
        resume_wave = wave_start_of(resume_from)
        resume_dir = os.path.dirname(os.path.abspath(resume_from))
        # Every rank checks, so that all raise alike before any work.
        for rep in range(min(resume_wave, R)):
            fin = wave_path(resume_dir, rep - rep % W, rep)
            if not os.path.exists(fin):
                raise FileNotFoundError(
                    f"resume needs the finished replication's file {fin}")

    def replication(wave_start, rep):
        if wave_start < resume_wave:
            return solver.replication_from_file(
                wave_path(resume_dir, wave_start, rep), rep)
        resume = None
        if wave_start == resume_wave:
            fin = wave_path(resume_dir, wave_start, rep)
            if os.path.exists(fin):
                return solver.replication_from_file(fin, rep)
            resume = newest_wave_checkpoint(resume_dir, wave_start, rep)
        return solver.solve_replication(
            rep, log=log, checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, resume_from=resume,
            wave_start=wave_start, shard=shard)

    results = []
    for wave_start in range(0, R, W):
        slot = None                      # an idle rank or group
        if group is not None and wave_start + group < R:
            rep = wave_start + group
            try:
                res = replication(wave_start, rep)
                # The group's obs rank 0 reports the replication.
                slot = (rep, True, res if coords[1] == 0 else None)
            except Exception:            # every rank must learn of it
                slot = (rep, False, traceback.format_exc())
        gathered = sorted((s for s in all_gather(slot) if s is not None),
                          key=lambda s: s[0])
        for rep, ok, text in gathered:
            if not ok:
                raise RuntimeError(f"replication {rep} failed:\n{text}")
        results += [res for _, _, res in gathered if res is not None]
    return results
