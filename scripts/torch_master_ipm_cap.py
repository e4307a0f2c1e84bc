"""Why the port's master IPM has a cap of 200 iterations where the JAX
package has 60.

Runs the port's batch-1 SD on ``stormlike`` on the CPU (small pools, the
first RUN_SEED) for ``--iters`` iterations, keeps every master QP whose
interior-point solve needed more than ``--report`` iterations, and solves
each again with the port at caps 60 and 200 and with the JAX package's
solve_qp (cap 60).  Prints one JSON line per such QP.

    JAX_PLATFORMS=cpu python scripts/torch_master_ipm_cap.py --iters 24

About 80 s on a CPU.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stochasticdecomposition_torch.core.master as port_master  # noqa: E402
from stochasticdecomposition_torch.config import SDConfig  # noqa: E402
from stochasticdecomposition_torch.models.suite import (  # noqa: E402
    load_suite_instance,
)
from stochasticdecomposition_torch.ops.qp import solve_qp  # noqa: E402
from stochasticdecomposition_torch.prob import (  # noqa: E402
    attach_stoc, decompose,
)
from stochasticdecomposition_torch.runner import SDSolver  # noqa: E402
from stochasticdecomposition_tpu.ops.qp import (  # noqa: E402
    solve_qp as jax_solve_qp,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--report", type=int, default=40)
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)

    hard = []

    def recording(*a, **kw):
        res = solve_qp(*a, **kw)
        if res.iters > args.report or not res.converged:
            hard.append((a, kw))
        return res

    port_master.solve_qp = recording
    core, tim, stoc = load_suite_instance("stormlike")
    sp = attach_stoc(decompose(core, tim, stoc), stoc)
    cfg = SDConfig(EVAL_FLAG=False, MAX_ITER=args.iters, MAX_OMEGA=128,
                   MAX_LAMBDA=300, MAX_SIGMA=300)
    res = SDSolver(sp, cfg, device="cpu").solve_replication(0)
    for a, kw in hard:
        out = {"vars": a[0].shape[0],
               "active_rows": int(kw["ineq_mask"].sum())}
        for cap in (60, 200):
            r = solve_qp(*a, **{**kw, "max_iter": cap})
            out[f"port_cap{cap}"] = {"converged": r.converged,
                                     "iters": r.iters, "obj": float(r.obj)}
        jr = jax_solve_qp(*(jnp.asarray(x.numpy()) for x in a),
                          **{k: jnp.asarray(v.numpy()) if
                             isinstance(v, torch.Tensor) else v
                             for k, v in kw.items()})
        out["jax_cap60"] = {"converged": bool(jr.converged),
                            "iters": int(jr.iters), "obj": float(jr.obj)}
        print(json.dumps(out), flush=True)
    print(json.dumps({"iterations": res.iterations,
                      "master_failures": res.master_failures,
                      "hard_masters": len(hard)}))


if __name__ == "__main__":
    main()
