"""One rank of the port's multi-process runs on the CPU (not a test module).

``tests/test_torch_mesh.py`` starts WORLD copies of this script, joined by
``torch.distributed`` over ``gloo`` through a ``file://`` store: the CPU
emulation of one process per card.  Each rank writes what it returned to
``<outdir>/<scenario>_rank<R>.json``.

Usage: python torch_mesh_worker.py <scenario> <rank> <world> <store> <outdir>

Scenarios:
  main  (4 ranks) — lands on a 2x2 mesh (two replications, the compromise);
        feastest on a 2x2 mesh (feasibility mode); three lands replications
        on a 2x1 mesh (two waves, an idle group, two ranks past the mesh);
        the sharded evaluation of 64 lanes on pgp2like, drawn from a
        generator and injected (``<outdir>/eval_inputs.npz``: ``x`` and
        ``w_raw``, written by the test before it starts the ranks); four lands
        replications at SAMPLE_INCREMENT 4 on a 2x1 mesh with checkpoints,
        then the same run resumed from a wave-2 checkpoint in a directory
        that holds only what a run killed there would have left.
  fail  (2 ranks) — rank 1's replication raises; every rank must fail.
  cli   (2 ranks) — ``cli.main(CLI_RUN + CLI_MESH)``, each rank with its own
        output directory ``<outdir>/cli_rank<R>``; the CLI joins the group
        itself (``--distributed``) from COORDINATOR_ADDRESS, NUM_PROCESSES
        and PROCESS_ID, and leaves it before it returns.
  groups (4 ranks) — ``run_groups``: the groups and the many gathers of
        the main scenario in a few seconds; before the ranks left their
        groups, one run in two or more ended with a rank aborting at exit
        (SIGABRT) after its work.

Every rank leaves its groups (``distributed.shutdown``) before it exits.
"""

import glob
import json
import os
import shutil
import sys

import numpy as np
import torch

CONFIGS = {
    "lands_2x2": ("lands", (2, 2), dict(MAX_ITER=60, EVAL_FLAG=False,
                                        MULTIPLE_REP=2,
                                        COMPROMISE_PROB=True)),
    "feastest_2x2": ("feastest", (2, 2), dict(MAX_ITER=40, EVAL_FLAG=False,
                                              MULTIPLE_REP=2)),
    "lands_waves": ("lands", (2, 1), dict(MAX_ITER=30, EVAL_FLAG=False,
                                          MULTIPLE_REP=3)),
    "lands_ckpt": ("lands", (2, 1), dict(MAX_ITER=64, EVAL_FLAG=False,
                                         MULTIPLE_REP=4, SAMPLE_INCREMENT=4)),
}
CLI_RUN = ["-p", "lands", "-m", "2", "-c", "1", "--max-iter", "30", "-e",
           "0", "--device", "cpu"]
CLI_MESH = ["--mesh", "2x1", "--distributed", "--metrics-every", "5"]
CKPT_EVERY = 10
EVAL_LANES = 64
EVAL_SEED = 7
GROUP_ROUNDS = 1000
LEAD_SECONDS = 0.2


def solver_for(name, cfg_kw):
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.models.instances import load_instance
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.runner import SDSolver

    core, tim, stoc = load_instance(name)
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    return SDSolver(sp, SDConfig(**cfg_kw), device="cpu")


def result_json(result):
    reps = [{"rep": r.rep, "iterations": r.iterations, "optimal": r.optimal,
             "incumb_x": r.incumb_x.tolist(), "incumb_est": r.incumb_est,
             "unique_omegas": r.unique_omegas, "pool_sizes": r.pool_sizes,
             "feas_rounds": r.feas_rounds, "cuts_formed": r.cuts_formed,
             "lp_count": r.lp_count}
            for r in result.replications]
    out = {"replications": reps, "compromise_x": None, "average_x": None}
    if result.compromise_x is not None:
        out["compromise_x"] = result.compromise_x.tolist()
        out["average_x"] = result.average_x.tolist()
    return out


def run_main(rank, outdir):
    import torch.distributed as dist

    from stochasticdecomposition_torch.core.evaluate import eval_generator
    from stochasticdecomposition_torch.parallel.mesh import (
        make_mesh, make_sharded_eval,
    )

    out = {}
    for key in ("lands_2x2", "feastest_2x2", "lands_waves"):
        name, shape, cfg_kw = CONFIGS[key]
        solver = solver_for(name, cfg_kw)
        mesh = make_mesh(*shape)
        out[key] = result_json(solver.run(mesh=mesh))
        out[key]["coords"] = mesh.coords()

    solver = solver_for("pgp2like", dict(MAX_ITER=40, EVAL_FLAG=False))
    mesh = make_mesh(4, 1)
    fn = make_sharded_eval(solver.pa, solver.spec, EVAL_LANES, mesh)
    gen = eval_generator(EVAL_SEED, "cpu")
    out["sharded_eval"] = list(fn(solver.mean_sol, gen))
    inputs = np.load(os.path.join(outdir, "eval_inputs.npz"))
    out["sharded_eval_injected"] = list(fn(
        torch.as_tensor(inputs["x"]), w_raw=torch.as_tensor(inputs["w_raw"])))

    name, shape, cfg_kw = CONFIGS["lands_ckpt"]
    solver = solver_for(name, cfg_kw)
    mesh = make_mesh(*shape)
    whole_dir = os.path.join(outdir, "ckpt_whole")
    out["ckpt_whole"] = result_json(solver.run(
        mesh=mesh, checkpoint_every=CKPT_EVERY, checkpoint_dir=whole_dir))
    # What a run killed in wave 2 leaves: wave 0's final files and wave 2's
    # first two checkpoints of each replication.
    killed_dir = os.path.join(outdir, "ckpt_killed")
    if rank == 0:
        os.makedirs(killed_dir)
        keep = glob.glob(os.path.join(whole_dir, "mesh_wave00_*_final.npz"))
        for rep in (2, 3):
            keep += sorted(glob.glob(os.path.join(
                whole_dir, f"mesh_wave02_rep{rep:02d}_k*.npz")))[:2]
        for p in keep:
            shutil.copy(p, killed_dir)
    dist.barrier()
    resume = sorted(glob.glob(os.path.join(killed_dir, "mesh_wave02_*")))[0]
    out["ckpt_resumed"] = result_json(solver.run(
        mesh=mesh, checkpoint_every=CKPT_EVERY, checkpoint_dir=killed_dir,
        resume_from=resume))
    out["ckpt_resumed"]["resume_from"] = os.path.basename(resume)
    out["ckpt_files"] = sorted(os.listdir(whole_dir))
    return out


def run_fail(rank, outdir):
    from stochasticdecomposition_torch.parallel.mesh import make_mesh
    from stochasticdecomposition_torch.runner import SDSolver

    solver = solver_for("lands", dict(MAX_ITER=20, EVAL_FLAG=False,
                                      MULTIPLE_REP=2))
    if rank == 1:
        def broken(self, rep, **kw):
            raise RuntimeError(f"injected failure in replication {rep}")
        SDSolver.solve_replication = broken
    solver.run(mesh=make_mesh(2, 1))
    return {}


def run_groups(rank, outdir):
    """The groups of the main scenario and its traffic, without the runs:
    the obs groups of a 2x2 mesh and one ``obs_sum`` on each, then
    GROUP_ROUNDS gathers on the wave group; the two lead ranks then work on
    (LEAD_SECONDS) while the others leave."""
    import time

    from stochasticdecomposition_torch.parallel import distributed
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    shard = make_mesh(2, 2).obs_shard(64)
    total = distributed.obs_sum(torch.full((3,), float(rank)), shard)
    for i in range(GROUP_ROUNDS):
        gathered = distributed.all_gather((rank, i))
    if rank < 2:
        time.sleep(LEAD_SECONDS)
    return {"obs_sum": total.tolist(), "gathered": gathered}


def run_cli(rank, outdir):
    from stochasticdecomposition_torch import cli
    from stochasticdecomposition_torch.parallel.distributed import (
        process_count,
    )

    rc = cli.main(CLI_RUN + CLI_MESH +
                  ["-o", os.path.join(outdir, f"cli_rank{rank}")])
    # The CLI left the group it joined: one process again.
    return {"rc": rc, "world": process_count()}


def main():
    scenario, rank, world, store, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from stochasticdecomposition_torch.parallel.distributed import (
        maybe_initialize, process_count, shutdown,
    )
    if scenario == "cli":
        os.environ.update(COORDINATOR_ADDRESS=f"file://{store}",
                          NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    else:
        assert maybe_initialize(coordinator_address=f"file://{store}",
                                num_processes=world, process_id=rank)
        assert process_count() == world
    out = {"main": run_main, "fail": run_fail,
           "cli": run_cli, "groups": run_groups}[scenario](rank, outdir)
    with open(os.path.join(outdir, f"{scenario}_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    shutdown()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
