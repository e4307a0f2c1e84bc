"""One rank of the port's obs-sharded runs on the CPU (not a test module).

``tests/test_torch_obs_shard.py`` writes ``<outdir>/plan.json`` (and the
inputs it names) and starts WORLD = 4 copies of this script, joined by
``torch.distributed`` over ``gloo`` through a ``file://`` store.  Each rank
writes what it computed to ``<outdir>/rank<R>.npz`` (arrays) and
``<outdir>/rank<R>.json``.

Usage: python torch_obs_worker.py <rank> <world> <store> <outdir>

The plan's parts, in order (every rank takes part in each):
  cuts     — a port state (``<outdir>/<case>.npz``, its fields) and an
             observation to draw: on a 1x4 and a 2x2 mesh, each rank keeps
             its block of the state's observation columns and makes one
             cut (dedup, warm subproblem solve, stochastic updates,
             ``form_cut``, ``add_cut``); and, with the first FEAS_RAYS
             sigma entries marked as rays, crosses them with every
             observation into feasibility cuts (``update_feas_cut_pool``);
  steps    — runs of ``make_step`` on injected draws
             (``<outdir>/<job>_draws.npy``) from a fresh sharded state, job
             j on rep group j % 2 of a 2x2 mesh; on the final state the
             bootstrap's draws from a seeded generator, and
             ``bootstrap_bounds``/``full_test`` on injected resampling
             draws (``<outdir>/<job>_boot.npy``) over an EPSILON sweep;
  runs     — ``SDSolver.run(mesh=)`` over a 2x2 mesh;
  resume   — the plan's ``resume`` run over a 2x2 mesh with a checkpoint
             every ``resume.every`` samples (``<outdir>/resume_whole``),
             then, from what a run killed after its first two checkpoints
             of each replication would have left, resumed over a 2x2 mesh
             and over a 2x1 mesh (each in its own directory);
  cli      — ``cli.main(plan's arguments + ["-o", <outdir>/cli_rank<R>])``;
  lockstep — a run whose obs rank 1 reports a perturbed lockstep digest:
             every rank must raise (its message is recorded);
  groups   — whether two meshes of one shape share their obs group, and
             this rank's count and seconds of obs collectives.
"""

import json
import os
import sys

import numpy as np
import torch


def problem(spec):
    from stochasticdecomposition_torch.models.instances import load_instance
    from stochasticdecomposition_torch.models.synthetic import parse_synthetic
    from stochasticdecomposition_torch.prob import attach_stoc, decompose

    name, synth = spec["name"], spec.get("synthetic")
    core, tim, stoc = (parse_synthetic(**synth) if synth
                       else load_instance(name))
    return attach_stoc(decompose(core, tim, stoc), stoc)


def solver_for(spec):
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.runner import SDSolver

    return SDSolver(problem(spec), SDConfig(**spec["cfg"]), device="cpu")


def shard_state(state, shard):
    """``state`` holding only ``shard``'s observation columns (with random
    costs ``obs_feas``'s too)."""
    if shard is None:
        return state
    lo, hi = shard.lo, shard.hi
    blocks = {}
    if state.obs_feas.shape[1] == state.omega_w.shape[0]:
        blocks["obs_feas"] = state.obs_feas[:, lo:hi].clone()
    return state._replace(
        omega_vals=state.omega_vals[lo:hi].clone(),
        omega_w=state.omega_w[lo:hi].clone(),
        delta_pib=state.delta_pib[:, lo:hi].clone(),
        delta_piC=state.delta_piC[:, lo:hi].clone(),
        cut_istar=state.cut_istar[:, lo:hi].clone(),
        shard=shard, **blocks)


OBS_FIELDS = ("omega_vals", "omega_w", "delta_pib", "delta_piC", "cut_istar",
              "obs_feas")
REPLICATED = ("candid_x", "incumb_x", "incumb_est", "candid_est",
              "quad_scalar", "pi_ratio", "sigma_pib", "sigma_piC",
              "lambda_vals", "cut_alpha", "cut_beta", "cut_mask", "pi_cuts")
FEAS_RAYS = 2
COUNTS = ("k", "omega_cnt", "lambda_cnt", "sigma_cnt", "lp_cnt", "cut_cnt",
          "i_cut_updt", "ratio_cnt", "dual_stable")


def state_record(state, tag, arrays):
    """The state's replicated fields and this rank's obs columns into
    ``arrays`` (under ``tag``); returns its counts."""
    for f in REPLICATED + OBS_FIELDS:
        arrays[f"{tag}/{f}"] = getattr(state, f).numpy()
    out = {f: getattr(state, f) for f in COUNTS}
    out["obs_shapes"] = [list(getattr(state, f).shape) for f in OBS_FIELDS]
    return out


def one_cut(pa, state, w, k, tol):
    """The cut test_torch_cuts.py makes (test_torch_randcost.py's with
    random costs), on a (sharded) port state."""
    from stochasticdecomposition_torch.core.cuts import add_cut, form_cut
    from stochasticdecomposition_torch.core.step import problem_path
    from stochasticdecomposition_torch.core.update import (
        calc_omega, omega_row, warm_solve_subproblem,
    )

    path = problem_path(pa)
    state = state._replace(k=k)
    state, o_idx, new_o = calc_omega(state, w, tol)
    res, state = warm_solve_subproblem(pa, state, state.candid_x,
                                       omega_row(state, o_idx))
    state, _ = path.updates(pa, state, res, o_idx, new_o, k, tol)
    parts, state = form_cut(pa, state, state.candid_x, k, dual_stability=True,
                            pi_eval_start=0, pi_cycle=1, scan_len=256,
                            argmax=path.argmax, accumulate=path.accumulate)
    state, slot = add_cut(pa, state, parts, k, incumbent=False, tol=tol)
    return parts, state, slot


def feas_cuts(pa, state):
    """The feasibility cuts of the first FEAS_RAYS sigma entries, taken as
    rays, crossed with every observation: (alpha [n], beta [n, n1])."""
    from stochasticdecomposition_torch.config import SDConfig
    from stochasticdecomposition_torch.core.feasibility import (
        update_feas_cut_pool,
    )

    state.sigma_feas[:FEAS_RAYS] = False
    _, alpha, beta = update_feas_cut_pool(
        pa, state._replace(f_updt=(0, 0)), SDConfig(), [], [])
    return np.asarray(alpha), np.stack(beta)


def run_cuts(plan, out, arrays):
    from stochasticdecomposition_torch.core.state import stage_problem
    from stochasticdecomposition_torch.interop import state_from_numpy
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    for case in plan["cuts"]:
        pa = stage_problem(problem(case), torch.device("cpu"))
        with np.load(os.path.join(plan["outdir"],
                               case["tag"] + ".npz")) as data:
            fields = dict(data)
        w = torch.as_tensor(fields.pop("__w"))
        k = int(fields.pop("__k"))
        for shape in ((1, 4), (2, 2)):
            mesh = make_mesh(*shape)
            state = state_from_numpy(fields)
            shard = mesh.obs_shard(state.omega_w.shape[0])
            parts, state, slot = one_cut(pa, shard_state(state, shard), w, k,
                                         case["tol"])
            tag = f"cut/{case['tag']}/{shape[0]}x{shape[1]}"
            arrays[f"{tag}/feas_alpha"], arrays[f"{tag}/feas_beta"] = \
                feas_cuts(pa, shard_state(state_from_numpy(fields), shard))
            arrays[f"{tag}/istar"] = parts.istar.numpy()
            arrays[f"{tag}/alpha"] = parts.alpha.numpy()
            arrays[f"{tag}/beta"] = parts.beta.numpy()
            out[tag] = {"slot": slot, "found": parts.found,
                        "lo": shard.lo, "hi": shard.hi,
                        **state_record(state, tag, arrays)}


def run_steps(plan, out, arrays):
    from stochasticdecomposition_torch.core.state import init_state
    from stochasticdecomposition_torch.core.stopping import (
        bootstrap_bounds, bootstrap_draws, full_test,
    )
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    group, _ = mesh.coords()
    for j, job in enumerate(plan["steps"]):
        if j % 2 != group:
            continue
        solver = solver_for(job)
        shard = mesh.obs_shard(solver.caps.O)
        state = init_state(solver.pa, solver.caps, solver.cfg,
                           solver.mean_sol, shard)
        draws = np.load(os.path.join(plan["outdir"], job["tag"] +
                                     "_draws.npy"))
        for w in draws:
            state = solver.step(state, None, torch.as_tensor(w))
        tag = f"steps/{job['tag']}"
        out[tag] = {"lo": shard.lo, "hi": shard.hi,
                    **state_record(state, tag, arrays)}
        if not job.get("boot"):
            continue
        gen = torch.Generator().manual_seed(plan["boot_seed"])
        arrays[f"{tag}/boot_draws"] = bootstrap_draws(
            state, gen, plan["boot_reps"]).numpy()
        boot = torch.as_tensor(np.load(os.path.join(
            plan["outdir"], job["tag"] + "_boot.npy")))
        est, lb = bootstrap_bounds(solver.pa, solver.cfg, state, boot)
        arrays[f"{tag}/boot_est"] = est.numpy()
        arrays[f"{tag}/boot_lb"] = lb.numpy()
        verdicts = []
        for eps in plan["epsilons"]:
            solver.cfg.EPSILON = eps
            verdicts.append(full_test(solver.pa, solver.cfg, state, boot))
        out[tag]["verdicts"] = verdicts


def result_json(result):
    reps = [{"rep": r.rep, "iterations": r.iterations, "optimal": r.optimal,
             "incumb_x": r.incumb_x.tolist(), "incumb_est": r.incumb_est,
             "unique_omegas": r.unique_omegas, "pool_sizes": r.pool_sizes,
             "feas_rounds": r.feas_rounds, "cuts_formed": r.cuts_formed}
            for r in result.replications]
    out = {"replications": reps, "compromise_x": None, "average_x": None}
    if result.compromise_x is not None:
        out["compromise_x"] = result.compromise_x.tolist()
        out["average_x"] = result.average_x.tolist()
    return out


def run_runs(plan, out):
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    for job in plan["runs"]:
        out[f"run/{job['tag']}"] = result_json(
            solver_for(job).run(mesh=make_mesh(2, 2)))


def run_resume(plan, out):
    """Checkpoints of a run over a 2x2 mesh, and its resume over 2x2 and
    2x1 from what a run killed after two checkpoints would have left."""
    import glob
    import shutil

    import torch.distributed as dist

    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    job = plan["resume"]
    every = job["every"]
    solver = solver_for(job)
    root = plan["outdir"]
    whole_dir = os.path.join(root, "resume_whole")
    out["resume/whole"] = result_json(solver.run(
        mesh=make_mesh(2, 2), checkpoint_every=every,
        checkpoint_dir=whole_dir))
    keep = [p for rep in range(solver.cfg.MULTIPLE_REP)
            for p in sorted(glob.glob(os.path.join(
                whole_dir, f"mesh_wave00_rep{rep:02d}_k*.npz")))[:2]]
    out["resume/files"] = sorted(os.listdir(whole_dir))
    out["resume/kept"] = [os.path.basename(p) for p in keep]
    for shape in ("2x2", "2x1"):
        d = os.path.join(root, f"resume_{shape}")
        if dist.get_rank() == 0:
            os.makedirs(d)
            for p in keep:
                shutil.copy(p, d)
        dist.barrier()
        out[f"resume/{shape}"] = result_json(solver.run(
            mesh=make_mesh(*(int(v) for v in shape.split("x"))),
            checkpoint_every=every, checkpoint_dir=d,
            resume_from=os.path.join(d, os.path.basename(keep[0]))))


def run_lockstep(plan, out):
    from stochasticdecomposition_torch import runner
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    if mesh.coords()[1] == 1:
        digest = runner.lockstep_digest
        runner.lockstep_digest = lambda state: digest(state) + 1
    try:
        solver_for(plan["lockstep"]).run(mesh=mesh)
        out["lockstep"] = None
    except RuntimeError as e:
        out["lockstep"] = str(e)


def run_groups(out):
    from stochasticdecomposition_torch.parallel import distributed
    from stochasticdecomposition_torch.parallel.mesh import make_mesh

    out["groups"] = {
        "shared": make_mesh(2, 2).obs_group is make_mesh(2, 2).obs_group,
        "obs_calls": distributed.obs_calls,
        "obs_seconds": distributed.obs_seconds}


def main():
    rank, world, store, outdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from stochasticdecomposition_torch import cli
    from stochasticdecomposition_torch.parallel.distributed import (
        maybe_initialize, shutdown,
    )

    assert maybe_initialize(coordinator_address=f"file://{store}",
                            num_processes=world, process_id=rank)
    with open(os.path.join(outdir, "plan.json")) as fh:
        plan = json.load(fh)
    plan["outdir"] = outdir
    out, arrays = {}, {}
    run_cuts(plan, out, arrays)
    run_steps(plan, out, arrays)
    run_runs(plan, out)
    run_resume(plan, out)
    out["cli_rc"] = cli.main(plan["cli"] +
                             ["-o", os.path.join(outdir, f"cli_rank{rank}")])
    run_lockstep(plan, out)
    run_groups(out)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    shutdown()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
