"""Command line interface.

Mirrors the reference CLI (parseCmdLine, twoSD.c:67-128) as the JAX
package's ``cli.py`` does: ``-p`` problem name, ``-i`` input dir, ``-o``
output dir, ``-e`` eval flag, ``-d`` dual stability, ``-t {l,n,t}``
tolerance preset, ``-m`` replications, ``-c`` compromise; ``--config`` for
a config.sd file (readConfig, twoSD.c:152-254); checkpoints, resume, seed
offset, metrics stream and phase times; and ``--device {cuda,cpu}``, the
device the run uses (the CUDA card unless the CPU is asked for).
``--mesh RxO`` runs the replications over a (rep x obs) mesh of ranks and
``--distributed`` joins the ranks' process group first, one process per
card (``parallel/``): R replications at a time, each on O ranks that split
its observation columns (its omega pool, delta tables and cut iStar
records) between them and step it in lockstep:

    torchrun --nproc_per_node N -m stochasticdecomposition_torch.cli \
        -p lands -m 4 --mesh 4x1 --distributed
    torchrun --nproc_per_node 2 -m stochasticdecomposition_torch.cli \
        -p pgp2like --mesh 1x2 --distributed

Each rank's first line names its card; only the coordinator (rank 0)
prints the summaries and writes the result files.  With
``--checkpoint-every``, ``--mesh`` needs an O of 1 and a
``--checkpoint-dir`` that every rank reaches: each rank that runs a
replication writes its files there.

Usage:  python -m stochasticdecomposition_torch.cli -p lands -o out/
Built-in instances resolve without ``-i`` (e.g. ``-p lands``).  Results go
to ``<out>/twoSD_torch/<prob>/``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from stochasticdecomposition_torch.config import SDConfig, load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="twoSD-torch",
        description="Two-stage stochastic decomposition in PyTorch")
    p.add_argument("-p", dest="prob_name", required=True,
                   help="problem name (SMPS base name or built-in instance)")
    p.add_argument("-i", dest="input_dir", default=None,
                   help="directory with <prob>.cor/.tim/.sto")
    p.add_argument("-o", dest="output_dir", default="./output",
                   help="output directory for result files")
    p.add_argument("-e", dest="eval_flag", type=int, default=None,
                   help="evaluate the final solution out of sample {0,1}")
    p.add_argument("-d", dest="dual_stability", type=int, default=None,
                   help="use the dual stability test {0,1}")
    p.add_argument("-t", dest="tolerance", choices=["l", "n", "t"],
                   default=None, help="tolerance preset: loose/nominal/tight")
    p.add_argument("-m", dest="multiple_rep", type=int, default=None,
                   help="number of replications")
    p.add_argument("-c", dest="compromise", type=int, default=None,
                   help="build and solve the compromise problem {0,1}")
    p.add_argument("--config", dest="config_path", default=None,
                   help="path to a config.sd file")
    p.add_argument("--max-iter", dest="max_iter", type=int, default=None)
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=0, metavar="N",
                   help="save the full solver state every N iterations")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    p.add_argument("--resume", dest="resume_from", default=None,
                   metavar="CKPT.npz",
                   help="resume replication 0 from a saved state")
    p.add_argument("--seed-offset", dest="seed_offset", type=int, default=0,
                   metavar="K",
                   help="rotate the RUN_SEED/EVAL_SEED banks by K entries so "
                        "replication r uses seed bank entry (r+K) mod 30 — "
                        "lets independent jobs cover disjoint seeds")
    p.add_argument("--metrics-every", dest="metrics_every", type=int,
                   default=0, metavar="N",
                   help="write a per-iteration JSONL metrics stream "
                        "(metrics_repNN.jsonl) every N iterations")
    p.add_argument("--time-phases", dest="time_phases", action="store_true",
                   help="estimate per-phase times (master/subproblem/"
                        "optimality/argmax) for detailedResults.csv by "
                        "timing the step's pieces on the final state")
    p.add_argument("--mesh", dest="mesh", default=None, metavar="RxO",
                   help="run replications over a (rep x obs) mesh of ranks, "
                        "e.g. --mesh 4x1 or 1x2 (requires R*O <= the number "
                        "of ranks): R replications at a time, each split "
                        "over O ranks by its observation columns (O must "
                        "divide the omega capacity; no checkpoints and no "
                        "random costs with O > 1)")
    p.add_argument("--distributed", dest="distributed", action="store_true",
                   help="join the ranks' process group before building the "
                        "mesh (coordinates from the environment: torchrun's "
                        "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK, or "
                        "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID)")
    p.add_argument("--device", dest="device", choices=["cuda", "cpu"],
                   default="cuda",
                   help="the device to run on (default: the CUDA card)")
    return p


def apply_seed_offset(cfg: SDConfig, offset: int) -> SDConfig:
    """Rotate the RUN_SEED/EVAL_SEED banks (config.sd:22-52,64-93) so
    replication r draws bank entry (r + offset) mod bank size — lets
    independent jobs cover disjoint seeds (``--seed-offset``)."""
    off = offset % len(cfg.RUN_SEED)
    cfg.RUN_SEED = cfg.RUN_SEED[off:] + cfg.RUN_SEED[:off]
    offe = offset % len(cfg.EVAL_SEED)
    cfg.EVAL_SEED = cfg.EVAL_SEED[offe:] + cfg.EVAL_SEED[:offe]
    return cfg


def main(argv=None) -> int:
    """The CLI; with ``--distributed`` it joins the process group (unless
    the caller has joined it already) and leaves it on its way out, on every
    rank alike: through a barrier after a run, at once after an error."""
    import torch.distributed as dist

    from stochasticdecomposition_torch.parallel.distributed import (
        maybe_initialize, shutdown,
    )
    args = build_parser().parse_args(argv)
    joined = args.distributed and not dist.is_initialized() and \
        maybe_initialize()
    if not joined:
        return _run(args)
    try:
        rc = _run(args)
    except BaseException:
        shutdown(barrier=False)
        raise
    shutdown()
    return rc


def _run(args) -> int:
    from stochasticdecomposition_torch.parallel.distributed import (
        is_coordinator, process_count, process_index, rank_device,
    )
    mesh = None
    if args.mesh:
        from stochasticdecomposition_torch.parallel.mesh import make_mesh
        try:
            n_rep, n_obs = (int(v) for v in args.mesh.lower().split("x"))
            mesh = make_mesh(n_rep, n_obs)
        except ValueError as e:
            print(f"--mesh expects RxO with R*O <= {process_count()} ranks "
                  f"(e.g. 2x4), got {args.mesh!r}: {e}", file=sys.stderr)
            return 2
        if args.checkpoint_every and not args.checkpoint_dir:
            print("--mesh with --checkpoint-every needs --checkpoint-dir, a "
                  "directory that every rank reads and writes (a resume "
                  "reads every rank's files)", file=sys.stderr)
            return 2
        if args.metrics_every or args.time_phases:
            print("--metrics-every and --time-phases are not taken with "
                  "--mesh: the meshed path records neither, as in the JAX "
                  "package", file=sys.stderr)
            args.metrics_every, args.time_phases = 0, False
    coord = is_coordinator()

    cfg = load_config(args.config_path) if args.config_path else SDConfig()
    if args.eval_flag is not None:
        cfg.EVAL_FLAG = bool(args.eval_flag)
    if args.dual_stability is not None:
        cfg.DUAL_STABILITY = bool(args.dual_stability)
    if args.tolerance is not None:
        cfg.apply_tolerance_preset(args.tolerance)
    if args.multiple_rep is not None:
        cfg.MULTIPLE_REP = args.multiple_rep
    if args.compromise is not None:
        cfg.COMPROMISE_PROB = bool(args.compromise)
    if args.max_iter is not None:
        cfg.MAX_ITER = args.max_iter
    if args.seed_offset:
        apply_seed_offset(cfg, args.seed_offset)
    if cfg.MULTIPLE_REP == 1:
        cfg.COMPROMISE_PROB = False

    from stochasticdecomposition_torch.models.instances import (
        INSTANCES, load_instance,
    )
    from stochasticdecomposition_torch.models.suite import (
        SUITE, load_suite_instance,
    )
    from stochasticdecomposition_torch.prob import attach_stoc, decompose
    from stochasticdecomposition_torch.runner import SDSolver
    from stochasticdecomposition_torch.smps import read_smps
    from stochasticdecomposition_torch.utils import io as sdio
    from stochasticdecomposition_torch.utils.metrics import MetricsRecorder

    if args.input_dir:
        core, tim, stoc = read_smps(args.input_dir, args.prob_name)
    elif args.prob_name in INSTANCES:
        core, tim, stoc = load_instance(args.prob_name)
    elif args.prob_name in SUITE:
        core, tim, stoc = load_suite_instance(args.prob_name)
    else:
        print(f"unknown problem {args.prob_name!r}: provide -i or use one of "
              f"{sorted(INSTANCES) + sorted(SUITE)}", file=sys.stderr)
        return 2

    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    device = rank_device(args.device)
    if mesh is not None:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" \
            else "CPU"
        print(f"rank {process_index()} of {process_count()}: {device} "
              f"({name})", flush=True)
    solver = SDSolver(sp, cfg, device=device)

    def log(s):
        sys.stdout.write(s)
        sys.stdout.flush()

    if coord:
        print("Starting two-stage stochastic decomposition (PyTorch).")
    if args.resume_from and not os.path.exists(args.resume_from):
        print(f"checkpoint not found: {args.resume_from}", file=sys.stderr)
        return 2
    out_dir = os.path.join(args.output_dir, "twoSD_torch", args.prob_name)
    ckpt_dir = args.checkpoint_dir
    if args.checkpoint_every and not ckpt_dir:
        ckpt_dir = os.path.join(out_dir, "checkpoints")
    metrics = None
    if args.metrics_every:
        os.makedirs(out_dir, exist_ok=True)

        def metrics(rep):
            return MetricsRecorder(
                os.path.join(out_dir, f"metrics_rep{rep:02d}.jsonl"),
                every=args.metrics_every)
    if coord:
        sdio.decompose_summary(sp, out=print)
    result = solver.run(log=log, checkpoint_every=args.checkpoint_every,
                        checkpoint_dir=ckpt_dir,
                        resume_from=args.resume_from, metrics=metrics,
                        time_phases=args.time_phases, mesh=mesh)
    print()
    if not coord:
        return 0
    for r in result.replications:
        sdio.print_optimization_summary(r, cfg.MAX_ITER)
        if r.eval is not None:
            sdio.print_evaluation_summary(r.eval)

    sdio.write_all(out_dir, result, sp=sp, max_iter=cfg.MAX_ITER)
    print(f"\nResults written to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
