"""Checkpoint / resume of one replication.

The reference has none (its state lives in RAM).  The port's ``SDState``
serializes to one ``.npz``: every field but ``shard`` (the layout of the
state it loads into, ``like``'s) by name — tensors as arrays, the
Python counts and flags as 0-d arrays, ``f_updt`` as a pair, and a field
that is ``None`` as the flag ``__host_none_<field>`` — plus ``__host_``
extras for the host loop, so that a resumed replication returns what an
uninterrupted one returns in every field but the times.  A tensor is saved
as its leading box outside which every element is zero bit for bit, with
its full shape as ``__host_shape_<field>``; loading pads it back with
zeros.  The pools are allocated at capacity and filled from the front, so
a checkpoint holds about their live prefixes (lands at the default
capacities: the [L, O] delta table alone is 300 MB in f64).  The extras:

  * ``gen_obs`` / ``gen_boot``: the states of the replication's two
    ``torch.Generator`` (observations and bootstrap resampling,
    ``runner.replication_generators``), with ``device_type``: a generator's
    state loads only into a generator on the same kind of device;
  * ``pool_alpha`` / ``pool_beta``: the feasibility cut pool (updtFeasCutPool's
    accumulated (ray x observation) cuts, cuts.c:465-517; ``f_updt``'s
    watermarks make it unreconstructable without them);
  * ``n_full_tests``, ``master_failures``, ``master_fails``: the counters the
    runner reports; in the meshed runner's files also ``wave_start`` and,
    in a replication's ``_final`` file, ``optimal``.

The meshed runner (``parallel/runner.py``) names its files by wave and
replication (``wave_path``): each rank that runs a replication writes that
replication's ``mesh_waveNN_repRR_kKKKKKK.npz`` on the sequential cadence
and its ``mesh_waveNN_repRR_final.npz`` when it ends, NN the wave's first
replication as in the JAX package's ``mesh_waveNN_*`` names.

A replication sharded over obs ranks (``SDState.shard``) writes the same
file: every obs rank of its group calls ``save_state`` at the same k, the
ranks' blocks of the observation-axis fields (``core/state.OBS_AXIS``:
``omega_vals``, ``omega_w``, ``delta_pib``, ``delta_piC``, ``cut_istar``,
and ``obs_feas`` with random costs) are gathered to obs rank 0, each as its
non-zero box, and obs rank 0 writes them at the full width O with the rest
of the state, which every rank holds alike.  ``load_checkpoint`` into a
sharded state keeps its rank's block of those fields, so one file resumes
on an Rx1 or an RxO mesh (or without one) alike.

A checkpoint written by the JAX package (``utils/checkpoint.py`` there)
loads too: the fields the port carries are kept, its PRNG key and JAX-only
fields are ignored (as ``interop.state_from_numpy`` does), and the port's own
counters start at their defaults.  The threefry key cannot be continued in
torch, so the resumed replication's generators start from its RUN_SEED.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stochasticdecomposition_torch.core.state import (
    OBS_AXIS, SDState, obs_fields,
)
from stochasticdecomposition_torch.interop import _convert

_HOST_PREFIX = "__host_"
_NONE_PREFIX = _HOST_PREFIX + "none_"
_SHAPE_PREFIX = _HOST_PREFIX + "shape_"
_SAME_SIZE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}
_COUNTERS = ("n_full_tests", "master_failures", "master_fails", "wave_start",
             "optimal")
# The field only the JAX package's state has; it marks its checkpoints.
_JAX_KEY = "key"
_SAVED = tuple(f for f in SDState._fields if f != "shard")


def _nonzero_box(t: torch.Tensor) -> torch.Tensor:
    """The leading box of ``t`` outside which every element is zero bit
    for bit (-0.0 and NaN are data), taken on ``t``'s device."""
    if not t.numel():
        return t
    nz = t.detach().view(_SAME_SIZE_INT[t.element_size()]) != 0
    ends = []
    for d in range(t.dim()):
        hit = torch.nonzero(nz.movedim(d, 0).reshape(t.shape[d], -1).any(1))
        ends.append(int(hit[-1]) + 1 if hit.numel() else 0)
    return t[tuple(slice(0, e) for e in ends)]


def _gathered_boxes(state: SDState) -> Optional[dict]:
    """Every obs rank's block of the observation-axis fields, gathered to
    obs rank 0 as {field: (box, full shape)}: each rank sends its non-zero
    box, and obs rank 0 places the boxes at their columns.  None on the
    other obs ranks.  A collective of the state's obs group."""
    sh = state.shard
    mine = {f: _nonzero_box(getattr(state, f)).cpu().numpy()
            for f in obs_fields(state)}
    group_ranks = dist.get_process_group_ranks(sh.group)
    parts = [None] * sh.n_obs if sh.lo == 0 else None
    dist.gather_object(mine, parts, dst=group_ranks[0], group=sh.group)
    if parts is None:
        return None
    width = sh.hi - sh.lo
    out = {}
    for f, ax in OBS_AXIS.items():
        if f not in mine:
            continue
        shape = list(getattr(state, f).shape)
        shape[ax] *= sh.n_obs
        ext = [max(p[f].shape[d] for p in parts) for d in range(len(shape))]
        ext[ax] = max((j * width + p[f].shape[ax]
                       for j, p in enumerate(parts) if p[f].shape[ax]),
                      default=0)
        box = np.zeros(ext, mine[f].dtype)
        for j, p in enumerate(parts):
            at = [slice(0, e) for e in p[f].shape]
            at[ax] = slice(j * width, j * width + p[f].shape[ax])
            box[tuple(at)] = p[f]
        out[f] = (box, tuple(shape))
    return out


def save_state(path: str, state: SDState, *, generators=(),
               pool_alpha: Optional[List[float]] = None,
               pool_beta: Optional[List[np.ndarray]] = None,
               counters: Optional[dict] = None) -> None:
    """Write ``state`` and the host extras to ``path`` (an ``.npz``).
    ``generators`` is the replication's (observations, bootstrap) pair.
    A state sharded over obs ranks: every obs rank of its group calls this
    at once, and obs rank 0 writes the one file (the module docstring)."""
    boxes = {}
    if state.shard is not None:
        boxes = _gathered_boxes(state)
        if boxes is None:
            return
    arrays = {}
    for f in _SAVED:
        v = getattr(state, f)
        if f in boxes:
            arrays[f] = boxes[f][0]
            arrays[_SHAPE_PREFIX + f] = np.asarray(boxes[f][1])
        elif v is None:
            arrays[_NONE_PREFIX + f] = np.asarray(True)
        elif isinstance(v, torch.Tensor) and v.dim():
            arrays[f] = _nonzero_box(v).cpu().numpy()
            arrays[_SHAPE_PREFIX + f] = np.asarray(v.shape)
        else:
            arrays[f] = np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                   else v)
    if generators:
        gen_obs, gen_boot = generators
        arrays[_HOST_PREFIX + "gen_obs"] = gen_obs.get_state().numpy()
        arrays[_HOST_PREFIX + "gen_boot"] = gen_boot.get_state().numpy()
        arrays[_HOST_PREFIX + "device_type"] = np.asarray(
            gen_obs.device.type)
    if pool_alpha:
        arrays[_HOST_PREFIX + "pool_alpha"] = np.asarray(pool_alpha)
        arrays[_HOST_PREFIX + "pool_beta"] = np.stack(pool_beta)
    for name, v in (counters or {}).items():
        arrays[_HOST_PREFIX + name] = np.asarray(int(v))
    np.savez_compressed(path, **arrays)


def load_state(path: str, like: SDState) -> SDState:
    """Load a checkpoint's state; ``like`` (a fresh ``init_state`` with the
    same capacities) supplies the device, the float dtype and the shapes."""
    state, _ = load_checkpoint(path, like)
    return state


def _block(arr: np.ndarray, shape: tuple, ax: int, lo: int,
           hi: int) -> np.ndarray:
    """Columns [lo, hi) along axis ``ax`` of the field of full ``shape``
    saved as its leading box ``arr``."""
    out_shape = list(shape)
    out_shape[ax] = hi - lo
    out = np.zeros(out_shape, arr.dtype)
    top = min(hi, arr.shape[ax])
    if top > lo:
        src = [slice(0, e) for e in arr.shape]
        src[ax] = slice(lo, top)
        dst = [slice(0, e) for e in arr.shape]
        dst[ax] = slice(0, top - lo)
        out[tuple(dst)] = arr[tuple(src)]
    return out


def load_checkpoint(path: str, like: SDState) -> Tuple[SDState, dict]:
    """Load a checkpoint and its host extras (``generators`` as the two
    state tensors, ``device_type``, ``pool_alpha``/``pool_beta``, the
    counters; only what the file holds).  Into a sharded ``like`` the
    observation-axis fields keep its block of columns.  Raises ValueError
    on a missing field or a shape that differs from ``like``'s."""
    dev, dtype = like.candid_x.device, like.candid_x.dtype
    with np.load(path) as data:
        data = dict(data)
    from_jax = _JAX_KEY in data
    kwargs = {"shard": like.shard}
    blocks = obs_fields(like) if like.shard is not None else ()
    for f in _SAVED:
        ref = getattr(like, f)
        if f not in data:
            if data.get(_NONE_PREFIX + f) is not None:
                kwargs[f] = None
                continue
            if from_jax and f in SDState._field_defaults:
                continue        # a port-only counter: its default
            # A checkpoint with fewer fields would resume with mixed
            # restored and fresh state: a silent break of the resume.
            raise ValueError(
                f"checkpoint {path} lacks state field {f!r}; resuming it "
                "would silently mix restored and fresh state")
        arr = data[f]
        shape = tuple(int(e) for e in data.get(_SHAPE_PREFIX + f, arr.shape))
        if f in blocks:                 # this rank's columns of the file's
            ax, sh = OBS_AXIS[f], like.shard
            full = list(ref.shape)
            full[ax] *= sh.n_obs
            if shape != tuple(full):
                raise ValueError(
                    f"checkpoint field {f} has shape {shape}, expected "
                    f"{tuple(full)} (capacities/config must match)")
            arr = _block(arr, shape, ax, sh.lo, sh.hi)
            shape = arr.shape
        if isinstance(ref, torch.Tensor) and shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint field {f} has shape {shape}, expected "
                f"{tuple(ref.shape)} (capacities/config must match)")
        if shape != arr.shape:          # a saved box: pad it with zeros
            box, arr = arr, np.zeros(shape, arr.dtype)
            arr[tuple(slice(0, e) for e in box.shape)] = box
        kwargs[f] = _convert(f, arr, dev, dtype)

    extras = {}
    if _HOST_PREFIX + "gen_obs" in data:
        extras["device_type"] = str(data[_HOST_PREFIX + "device_type"])
        extras["generators"] = tuple(
            torch.as_tensor(data[_HOST_PREFIX + g])
            for g in ("gen_obs", "gen_boot"))
    if _HOST_PREFIX + "pool_alpha" in data:
        extras["pool_alpha"] = [float(a)
                                for a in data[_HOST_PREFIX + "pool_alpha"]]
        extras["pool_beta"] = [np.asarray(b)
                               for b in data[_HOST_PREFIX + "pool_beta"]]
    for name in _COUNTERS:
        if _HOST_PREFIX + name in data:
            extras[name] = int(data[_HOST_PREFIX + name])
    return SDState(**kwargs), extras


def wave_path(directory: str, wave_start: int, rep: int,
              k: Optional[int] = None) -> str:
    """The meshed runner's file of replication ``rep`` in the wave that
    starts at ``wave_start``: its checkpoint at sample ``k``, or its
    ``_final`` file when ``k`` is None."""
    tail = "final" if k is None else f"k{k:06d}"
    return os.path.join(directory,
                        f"mesh_wave{wave_start:02d}_rep{rep:02d}_{tail}.npz")


def wave_start_of(path: str) -> int:
    """The first replication of the wave a meshed runner's file belongs to."""
    with np.load(path) as data:
        key = _HOST_PREFIX + "wave_start"
        if key not in data:
            raise ValueError(f"{path} is not a meshed runner's checkpoint")
        return int(data[key])


def newest_wave_checkpoint(directory: str, wave_start: int,
                           rep: int) -> Optional[str]:
    """The checkpoint of ``rep`` in that wave with the largest k, or None."""
    paths = sorted(glob.glob(os.path.join(
        glob.escape(directory),
        f"mesh_wave{wave_start:02d}_rep{rep:02d}_k*.npz")))
    return paths[-1] if paths else None
