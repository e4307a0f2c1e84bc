"""Partial pricing on stormlike's second-stage LP, cold, in both packages.

The mean observation's subproblem of ``stormlike`` (528 x 1259) at the
mean-value first-stage solution, solved from the slack basis by the port's
``solve_lp`` with full pricing and with ``partial_pricing`` (its defaults: a
window of 16 pivots, 256 candidates) and, with ``--jax``, by the JAX
package's ``solve_lp`` the same two ways on the same LP.  Prints one JSON
line per solve (package, device, pricing, status, pivots, objective,
seconds), and on the card the card as nvidia-smi gives it.  The warm lanes
the evaluator solves are ``chip_smoke.py``'s phase 18.

On the CPU, both packages (about 4 minutes):

    JAX_PLATFORMS=cpu python scripts/torch_partial_pricing_storm.py \\
        --device cpu --jax

On the card, the port alone (about 2 minutes):

    python3 scripts/torch_partial_pricing_storm.py
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from stochasticdecomposition_torch.config import SDConfig  # noqa: E402
from stochasticdecomposition_torch.core.update import (  # noqa: E402
    subproblem_rhs_cost_lanes,
)
from stochasticdecomposition_torch.models.suite import (  # noqa: E402
    load_suite_instance,
)
from stochasticdecomposition_torch.ops.simplex import solve_lp  # noqa: E402
from stochasticdecomposition_torch.prob import (  # noqa: E402
    attach_stoc, decompose,
)
from stochasticdecomposition_torch.runner import SDSolver  # noqa: E402


def storm_lp(device):
    """(D, sense, d, l, u, b) of the mean observation's subproblem at the
    mean-value solution, one lane."""
    core, tim, stoc = load_suite_instance("stormlike")
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    solver = SDSolver(sp, SDConfig(EVAL_FLAG=False), device=device)
    pa = solver.pa
    x = torch.as_tensor(solver.mean_sol, dtype=pa.c1.dtype, device=device)
    rhs, cost = subproblem_rhs_cost_lanes(
        pa, x, torch.zeros_like(pa.omega_mean)[None])
    return pa.D, pa.sense2, cost, pa.l2, pa.u2, rhs


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--jax", action="store_true",
                    help="also the JAX package's solve_lp (CPU)")
    args = ap.parse_args()
    D, sense, d, l, u, b = storm_lp(args.device)
    for pp in (False, True):
        sync(args.device)
        t = time.monotonic()
        res = solve_lp(D, sense, d, l, u, b, partial_pricing=pp)
        sync(args.device)
        print(json.dumps({
            "package": "torch", "device": args.device,
            "pricing": "partial" if pp else "full",
            "m": D.shape[0], "n": D.shape[1], "status": int(res.status[0]),
            "pivots": int(res.iters[0]), "objective": float(res.obj[0]),
            "seconds": time.monotonic() - t}), flush=True)
    if args.jax:
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        from stochasticdecomposition_tpu.ops.simplex import (
            solve_lp as jax_solve_lp,
        )
        lp = [jnp.asarray(a.cpu().numpy()) for a in (D, sense, d[0], l, u,
                                                     b[0])]
        for pp in (False, True):
            fn = jax.jit(lambda *a, pp=pp: jax_solve_lp(
                *a, partial_pricing=pp))
            t = time.monotonic()
            res = fn(*lp)
            status = int(res.status)
            print(json.dumps({
                "package": "jax", "device": "cpu",
                "pricing": "partial" if pp else "full", "status": status,
                "pivots": int(res.iters), "objective": float(res.obj),
                "seconds_with_compile": time.monotonic() - t}), flush=True)
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
