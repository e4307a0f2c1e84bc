"""Algorithm state: the cellType equivalent as fixed-capacity tensors.

The reference keeps all mutable algorithm state in ``cellType``
(twoSD.h:101-149) with pools preallocated to MAX_ITER-derived capacities
(setup.c:126,136-144).  Here every pool is a fixed-capacity tensor on the
run's device with a count, the same capacities as the JAX package, so the
per-iteration work runs over the full pools whatever their occupancy.

Counts and flags that the host loop branches on are plain Python numbers;
pools and iterates are tensors.  A replication sharded over the obs ranks
of a mesh (``parallel/mesh.py``) holds only its block of the observation
axis of ``omega_vals``, ``omega_w``, ``delta_pib``, ``delta_piC``,
``cut_istar`` and, with random costs, ``obs_feas`` (``SDState.shard``,
``obs_range``, ``obs_fields``); the counts, such as
``omega_cnt``, stay global.  The state is a NamedTuple, updated with
``_replace``; pool writes are made in place on the state's tensors (the
pools are the large part of device memory, so they are never copied).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stochasticdecomposition_torch.config import MASTER_QP, SDConfig
from stochasticdecomposition_torch.prob import StagedProblem


class ProblemArrays(NamedTuple):
    """Device-resident immutable problem data (probType equivalent)."""

    # First stage.
    A1: torch.Tensor          # [m1, n1]
    b1: torch.Tensor          # [m1]
    sense1: torch.Tensor      # [m1] int64
    c1: torch.Tensor          # [n1]
    l1: torch.Tensor          # [n1]
    u1: torch.Tensor          # [n1]
    # Second stage templates (means folded in).
    D: torch.Tensor           # [m2, n2]
    b_bar: torch.Tensor       # [m2]
    sense2: torch.Tensor      # [m2]
    C_bar: torch.Tensor       # [m2, n1]
    d_bar: torch.Tensor       # [n2]
    l2: torch.Tensor          # [n2]
    u2: torch.Tensor          # [n2]
    # Randomness coordinates.
    rv_b_rows: torch.Tensor   # [nb] int64
    rv_C_rows: torch.Tensor   # [nC]
    rv_C_cols: torch.Tensor   # [nC]
    rv_d_cols: torch.Tensor   # [nd]
    omega_mean: torch.Tensor  # [R]
    lambda_rows: torch.Tensor  # [nlr] rows with randomness (coord->rvRows)
    C_cols: torch.Tensor      # [nCc] first-stage cols of Cbar (coord->CCols)
    # Derived maps for the delta tables.
    bmap: torch.Tensor        # [nlr, nb]: lambda-row scatter of the b block
    lam_pos_C: torch.Tensor   # [nC]: position of rv_C_rows within lambda_rows
    Cgroup: torch.Tensor      # [nC, nCr] one-hot: rv C entry -> distinct col
    C_cols_rand: torch.Tensor  # [nCr] distinct first-stage cols w/ random C
    # Scalars.
    lb: float                 # lower bound on E[h]
    lb_nontrivial: bool
    # First-stage integrality (MASTER_TYPE 1/7, master.c:331); all False
    # for a continuous first stage.
    int1: torch.Tensor        # [n1] bool


class SDState(NamedTuple):
    """Mutable SD state (cellType, twoSD.h:101-149) for the plain path."""

    k: int                      # iteration counter (= samples drawn)
    lp_cnt: int

    # omegaType (stoc.h:33-39)
    omega_vals: torch.Tensor    # [O, R] centered observations
    omega_w: torch.Tensor       # [O] int64 weights
    omega_cnt: int

    # lambdaType (stoc.h:45-48)
    lambda_vals: torch.Tensor   # [L, nlr]
    lambda_cnt: int

    # sigmaType (stoc.h:55-60) + the per-entry feasibility flag
    sigma_pib: torch.Tensor     # [S]
    sigma_piC: torch.Tensor     # [S, nCc]
    sigma_lidx: torch.Tensor    # [S] int64 -> lambda row
    sigma_ck: torch.Tensor      # [S] int64 iteration first seen
    sigma_feas: torch.Tensor    # [S] bool (False = extreme ray entry)
    sigma_cnt: int

    # deltaType (stoc.h:68-70)
    delta_pib: torch.Tensor     # [L, O]
    delta_piC: torch.Tensor     # [L, O, nCr]

    # basisType (stoc.h:72-97), the random-cost (v2.0) path; 1-slot
    # placeholders without random costs.  As in the JAX package the phi
    # columns are indexed by the cost RV they belong to (basis_present)
    # instead of the reference's packed arrays.
    basis_cstat: torch.Tensor   # [B, n2] int8 column status (dedup + feas)
    basis_rstat: torch.Tensor   # [B, m2] int8
    basis_phi: torch.Tensor     # [B, nd, m2] dual-basis-inverse rows
    basis_present: torch.Tensor  # [B, nd] bool: cost RV n basic here
    basis_sigma0: torch.Tensor  # [B] int64 sigma entry of piDet
    basis_sigma_idx: torch.Tensor  # [B, nd] int64 sigma entry per phi col
    basis_pidet: torch.Tensor   # [B, m2]
    basis_gbar: torch.Tensor    # [B, n2] deterministic reduced costs
    basis_psi: torch.Tensor     # [B, nd, n2] tableau rows of phi positions
    basis_mub: torch.Tensor     # [B]
    basis_ck: torch.Tensor      # [B] int64
    basis_feas: torch.Tensor    # [B] bool
    basis_cnt: int
    obs_feas: torch.Tensor      # [B, O] bool: basis dual-feasible at obs

    # cutsType (twoSD.h:69-85): fixed slots, masked
    cut_alpha: torch.Tensor     # [K]
    cut_beta: torch.Tensor      # [K, n1]
    cut_ns: torch.Tensor        # [K] int64 numSamples at formation
    cut_omega_cnt: torch.Tensor  # [K] int64
    cut_istar: torch.Tensor     # [K, O] int64
    cut_mask: torch.Tensor      # [K] bool
    # feasibility cut slots (cell->fcuts), filled in feasibility mode
    # (core/feasibility.py) from the host-side feasibility cut pool
    fcut_alpha: torch.Tensor    # [F]
    fcut_beta: torch.Tensor     # [F, n1]
    fcut_mask: torch.Tensor     # [F] bool
    f_updt: tuple               # (sigma, omega) counts already crossed
    #                             into the feasibility cut pool (fUpdt)

    # incumbent & master (cellType scalars), 0-d tensors
    candid_x: torch.Tensor      # [n1]
    candid_est: torch.Tensor
    incumb_x: torch.Tensor      # [n1]
    incumb_est: torch.Tensor
    quad_scalar: torch.Tensor
    gamma: torch.Tensor
    norm_dk: torch.Tensor
    norm_dk_1: torch.Tensor
    i_cut_idx: int              # slot of the incumbent cut
    i_cut_updt: int             # iteration of last incumbent cut
    incumb_chg: bool
    pi_first: torch.Tensor      # [m1] master duals on first-stage rows
    pi_cuts: torch.Tensor       # [K] master duals on cut rows
    dj_master: torch.Tensor     # [n1] master reduced costs (bound duals)
    eta: torch.Tensor           # last master eta value

    # dual stability (cuts.c:171-182)
    pi_ratio: torch.Tensor      # [SCAN_LEN]
    dual_stable: bool
    ratio_cnt: int

    # status
    last_o_idx: int             # omega index of the current iteration
    sp_feas: bool               # every subproblem of the iteration optimal
    opt_mode: bool              # False while resolving infeasibility
    infeas_incumb: bool         # a feasibility cut cuts off the incumbent
    feas_cnt: int               # feasibility-mode rounds
    master_ok: bool             # last master solve converged
    cut_ok: bool                # last cut found a vertex for every obs

    # warm-start basis for the next subproblem solve
    warm_basis: torch.Tensor    # [m2] int64
    warm_atup: torch.Tensor     # [n2 + m2] bool (standard-form at-upper)

    lp_pivots: int = 0          # simplex pivots over all subproblem solves
    qp_iters: int = 0           # interior-point iterations over all masters
    cut_cnt: int = 0            # SD cuts formed (triple argmax calls)
    lane_iters: torch.Tensor | None = None  # [B] pivots of the last
    #                             batched subproblem solve, per lane
    shard: "ObsShard | None" = None  # this rank's observation columns
    #                             (parallel/distributed.ObsShard); None: all


# The observation axis of the fields a sharded state holds in blocks
# (``obs_feas`` only with random costs: otherwise a [B, 1] placeholder).
OBS_AXIS = {"omega_vals": 0, "omega_w": 0, "delta_pib": 1, "delta_piC": 1,
            "cut_istar": 1, "obs_feas": 1}


def obs_fields(state: SDState) -> tuple:
    """The fields of ``state`` that hold its observation columns: the
    OBS_AXIS fields at the width of ``omega_w`` (without random costs
    ``obs_feas`` is a placeholder every rank holds alike)."""
    width = state.omega_w.shape[0]
    return tuple(f for f, ax in OBS_AXIS.items()
                 if getattr(state, f).shape[ax] == width)


def obs_range(state: SDState) -> tuple:
    """(lo, hi, O): the global observation columns [lo, hi) this state
    holds, of O in all (the whole axis unless it is sharded)."""
    n = state.omega_w.shape[0]
    sh = state.shard
    return (0, n, n) if sh is None else (sh.lo, sh.hi, n * sh.n_obs)


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def stage_problem(sp: StagedProblem, device: torch.device,
                  dtype=torch.float64) -> ProblemArrays:
    rv = sp.rv
    nlr = len(rv.lambda_rows)
    nb, nC = rv.nb, rv.nC

    bmap = np.zeros((nlr, nb))
    lam_index = {int(r): i for i, r in enumerate(rv.lambda_rows)}
    for j, r in enumerate(rv.rv_b_rows):
        bmap[lam_index[int(r)], j] = 1.0

    C_cols_rand = np.unique(rv.rv_C_cols) if nC else np.zeros(0, np.int64)
    group_index = {int(ccol): q for q, ccol in enumerate(C_cols_rand)}
    Cgroup = np.zeros((nC, max(len(C_cols_rand), 1)))
    lam_pos_C = np.zeros(nC, np.int64)
    for j in range(nC):
        Cgroup[j, group_index[int(rv.rv_C_cols[j])]] = 1.0
        lam_pos_C[j] = lam_index[int(rv.rv_C_rows[j])]

    f, s = sp.first, sp.second
    i64 = torch.int64

    def fl(a):
        return _t(a, dtype, device)

    def ix(a):
        return _t(np.asarray(a, np.int64), i64, device)

    return ProblemArrays(
        A1=fl(f.A), b1=fl(f.b), sense1=ix(f.sense), c1=fl(f.c),
        l1=fl(f.lb), u1=fl(f.ub),
        D=fl(s.D), b_bar=fl(s.b_bar), sense2=ix(s.sense), C_bar=fl(s.C_bar),
        d_bar=fl(s.d_bar), l2=fl(s.lb), u2=fl(s.ub),
        rv_b_rows=ix(rv.rv_b_rows), rv_C_rows=ix(rv.rv_C_rows),
        rv_C_cols=ix(rv.rv_C_cols), rv_d_cols=ix(rv.rv_d_cols),
        omega_mean=fl(rv.omega_mean), lambda_rows=ix(rv.lambda_rows),
        C_cols=ix(rv.C_cols), bmap=fl(bmap), lam_pos_C=ix(lam_pos_C),
        Cgroup=fl(Cgroup), C_cols_rand=ix(C_cols_rand),
        lb=float(sp.lb), lb_nontrivial=not sp.lb_is_trivial,
        int1=_t(f.is_int if f.is_int is not None
                else np.zeros(f.A.shape[1], bool), torch.bool, device),
    )


class Capacities(NamedTuple):
    """Static pool capacities (setup.c:126,136-144 equivalents)."""

    O: int      # omega pool
    L: int      # lambda pool
    S: int      # sigma pool
    K: int      # optimality cut slots (maxCuts)
    F: int      # feasibility cut slots
    B: int      # basis pool (random-cost path; 1 when unused)
    scan: int   # SCAN_LEN


def derive_capacities(sp: StagedProblem, cfg: SDConfig) -> Capacities:
    n1 = sp.first.A.shape[1]
    cap = cfg.pool_capacity(sp.rv.nd)
    # k counts samples (matching the reference's iteration==sample), so at
    # most MAX_ITER observations are ever drawn regardless of batching.
    O = cfg.MAX_OMEGA or (cfg.MAX_ITER + max(1, cfg.SAMPLE_INCREMENT))
    O = ((O + 127) // 128) * 128      # same rounding as the JAX package
    L = cfg.MAX_LAMBDA or cap
    S = cfg.MAX_SIGMA or cap
    B = (cfg.MAX_BASES or (cfg.MAX_ITER + cfg.MAX_ITER // cfg.TAU + 1)) \
        if sp.rv.nd > 0 else 1
    return Capacities(O=O, L=L, S=S, K=cfg.max_cuts(n1),
                      F=cfg.max_cuts(n1), B=B, scan=cfg.SCAN_LEN)


def estimate_pool_bytes(sp: StagedProblem, caps: Capacities,
                        cfg: SDConfig, n_obs: int = 1) -> dict:
    """Static-pool memory breakdown (bytes) of one rank at the derived
    capacities, its observation axis split over ``n_obs`` ranks.

    delta is [L, O], so at MAX_ITER=5000 it alone is ~307 MB in f64, and
    the [L, O, nCr] C-part as much again per random C column, or once
    without random technology (its [L, O, 1] placeholder).  The full
    test's weights are [O] f64 on every rank, for the whole of O."""
    rv = sp.rv
    n1 = sp.first.A.shape[1]
    m2, n2 = sp.second.D.shape
    R = len(rv.omega_mean)
    nlr = max(len(rv.lambda_rows), 1)
    nCc = max(len(rv.C_cols), 1)
    nCr = max(len(np.unique(rv.rv_C_cols)) if rv.nC else 0, 1)
    nd = rv.nd
    L, S, K, F, B = caps.L, caps.S, caps.K, caps.F, caps.B
    O = caps.O // n_obs                 # this rank's columns
    fb = 8 if cfg.DTYPE == "float64" else 4

    out = {
        "omega": O * R * fb + O * 8,
        "lambda": L * nlr * fb,
        "sigma": S * (1 + nCc) * fb + S * 9,
        "delta_pib": L * O * fb,
        "delta_piC": L * O * nCr * fb,
        "cuts": K * (O * 8 + n1 * fb + fb + 8) + F * (n1 + 1) * fb,
        "bootstrap_weights": caps.O * 8,
    }
    if nd > 0:
        out["basis_phi"] = B * nd * m2 * fb
        out["basis_psi"] = B * nd * n2 * fb
        out["basis_other"] = B * ((n2 + m2) * (1 + fb) + nd * 5 + O + 16)
    out["total"] = sum(out.values())
    return out


def init_state(pa: ProblemArrays, caps: Capacities, cfg: SDConfig,
               x0, shard=None) -> SDState:
    """Fresh replication state (newCell, setup.c:67-186 / cleanCellType);
    with ``shard`` (``parallel/distributed.ObsShard``) the observation
    axis holds that shard's columns only."""
    dtype = pa.c1.dtype
    dev = pa.c1.device
    n1 = pa.c1.shape[0]
    R = pa.omega_mean.shape[0]
    nlr = pa.lambda_rows.shape[0]
    nCc = pa.C_cols.shape[0]
    nCr = pa.C_cols_rand.shape[0] if pa.C_cols_rand.shape[0] else 1
    O, L, S, K, F, B = caps.O, caps.L, caps.S, caps.K, caps.F, caps.B
    if shard is not None:
        O = shard.hi - shard.lo
    m2, n2 = pa.D.shape
    # The basis pool's inner widths collapse to 1 without random costs.
    rand_d = pa.rv_d_cols.shape[0] > 0
    ndb = pa.rv_d_cols.shape[0] if rand_d else 1
    m2b, n2b, Ob = (m2, n2, O) if rand_d else (1, 1, 1)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def sc(v):
        return torch.tensor(float(v), dtype=dtype, device=dev)

    i64 = torch.int64
    x0 = torch.as_tensor(np.asarray(x0), dtype=dtype, device=dev).clone()
    candid_est = pa.lb + pa.c1 @ x0    # setup.c:102

    return SDState(
        k=0, lp_cnt=0,
        omega_vals=z(O, R), omega_w=z(O, dt=i64), omega_cnt=0,
        lambda_vals=z(L, nlr), lambda_cnt=0,
        sigma_pib=z(S), sigma_piC=z(S, nCc), sigma_lidx=z(S, dt=i64),
        sigma_ck=z(S, dt=i64), sigma_feas=z(S, dt=torch.bool), sigma_cnt=0,
        delta_pib=z(L, O), delta_piC=z(L, O, nCr),
        basis_cstat=z(B, n2b, dt=torch.int8),
        basis_rstat=z(B, m2b, dt=torch.int8),
        basis_phi=z(B, ndb, m2b), basis_present=z(B, ndb, dt=torch.bool),
        basis_sigma0=z(B, dt=i64), basis_sigma_idx=z(B, ndb, dt=i64),
        basis_pidet=z(B, m2b), basis_gbar=z(B, n2b), basis_psi=z(B, ndb, n2b),
        basis_mub=z(B), basis_ck=z(B, dt=i64),
        basis_feas=z(B, dt=torch.bool), basis_cnt=0,
        obs_feas=z(B, Ob, dt=torch.bool),
        cut_alpha=z(K), cut_beta=z(K, n1), cut_ns=z(K, dt=i64),
        cut_omega_cnt=z(K, dt=i64), cut_istar=z(K, O, dt=i64),
        cut_mask=z(K, dt=torch.bool),
        fcut_alpha=z(F), fcut_beta=z(F, n1), fcut_mask=z(F, dt=torch.bool),
        f_updt=(0, 0),
        candid_x=x0, candid_est=candid_est.clone(),
        incumb_x=x0.clone(), incumb_est=candid_est.clone(),
        quad_scalar=sc(cfg.MIN_QUAD_SCALAR), gamma=sc(0.0),
        norm_dk=sc(0.0), norm_dk_1=sc(0.0),
        # LP masters have no incumbent cut slot (iCutIdx = -1, setup.c:113-119).
        i_cut_idx=0 if cfg.MASTER_TYPE == MASTER_QP else -1,
        i_cut_updt=0, incumb_chg=False,
        pi_first=z(pa.b1.shape[0]), pi_cuts=z(K), dj_master=z(n1),
        eta=sc(0.0),
        pi_ratio=z(caps.scan), dual_stable=not cfg.DUAL_STABILITY,
        ratio_cnt=0,
        last_o_idx=0, sp_feas=True, opt_mode=True, infeas_incumb=False,
        feas_cnt=0, master_ok=True, cut_ok=True,
        warm_basis=torch.arange(n2, n2 + m2, dtype=i64, device=dev),
        warm_atup=z(n2 + m2, dt=torch.bool),
        shard=shard,
    )
