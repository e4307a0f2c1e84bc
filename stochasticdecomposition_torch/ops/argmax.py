"""The triple masked argmax of the SD cut: CUDA kernel, plain version,
split plan, launch counter.

For each column o of the height table H [S, O] and for each of three row
masks (all valid dual vertices, old ones, new ones) it returns the first
argmax and the max of ``where(mask[:, None], H, -1e300)`` over axis 0 —
what the JAX package's ``ops/pallas_argmax.py`` computes with its TPU kernel
and, off the TPU, with ``triple_masked_argmax_xla``.  The kernel
(``csrc/triple_argmax.cu``) selects in f64 and is bit-identical to the plain
version.

The kernel cuts H into row tiles of ``TILE_ROWS`` rows and O-tiles of
``TILE_COLS`` columns, and deals the row tiles out to ``n_splits`` S-splits
in turn (split c takes tiles c, c + n_splits, ...); one block per (split,
O-tile) streams its tiles and skips those no mask selects.  ``split_plan``
chooses that split here, from the shapes alone, so that the CPU tests reach
it; the kernel takes it as arguments.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_NEG = -1e300

# The kernel's compile-time shape (csrc/triple_argmax.cu): rows per ring
# stage, columns per O-tile, the blocks an SM holds (its shared memory: 3
# stages of 32 x 128 f64 plus ~13.5 KB), and the most row tiles a block
# stages mask codes for.
TILE_ROWS = 32
TILE_COLS = 128
BLOCKS_PER_SM = 2
MAX_TILES = 128
H100_SMS = 132

# Kernel launches made by ``triple_masked_argmax`` (not by the plain
# version); a run resets it to 0 and reads it to show its path used the
# kernel.
launches = 0


class SplitPlan(NamedTuple):
    """How the kernel cuts H [S, O]: ``n_splits`` S-splits (split c takes
    the row tiles c, c + n_splits, ...) times ``n_otiles`` O-tiles, one
    block each.  With more than one split the blocks write (value, index)
    partials to a workspace [n_splits, 3, O] that the last block of each
    O-tile merges."""

    n_splits: int
    n_otiles: int
    use_tma: bool          # False: cp.async copies (H's rows not 16-B aligned)

    @property
    def blocks(self) -> int:
        return self.n_splits * self.n_otiles

    def workspace_shape(self, O: int) -> tuple:
        return (self.n_splits, 3, O) if self.n_splits > 1 else (0, 3, O)


def split_plan(S: int, O: int, *, aligned: bool = True,
               n_sms: int = H100_SMS,
               n_splits: int | None = None) -> SplitPlan:
    """The split of H [S, O] into (S-split, O-tile) blocks.

    By default the grid is one wave: as many splits as fill the card's
    ``n_sms`` SMs with ``BLOCKS_PER_SM`` blocks each, so every block runs
    from the start with an equal share of the row tiles (within one).  A
    block stages the codes of at most ``MAX_TILES`` tiles, and no split is
    without a tile.  ``aligned`` says whether H's base address is 16-byte
    aligned; TMA needs that and a row stride (O * 8 bytes) that is a
    multiple of 16."""
    if S < 1 or O < 1:
        raise ValueError(f"empty H [{S}, {O}]")
    n_tiles = -(-S // TILE_ROWS)
    n_otiles = -(-O // TILE_COLS)
    if n_splits is None:
        n_splits = BLOCKS_PER_SM * n_sms // n_otiles
    n_splits = min(max(n_splits, -(-n_tiles // MAX_TILES), 1), n_tiles)
    use_tma = aligned and (O * 8) % 16 == 0
    return SplitPlan(n_splits, n_otiles, use_tma)


def triple_masked_argmax_plain(H, base_mask, old_mask, new_mask):
    """Plain PyTorch version: three ``where`` + ``max(dim=0)`` passes."""
    out = []
    for mask in (base_mask, old_mask, new_mask):
        Hm = torch.where(mask[:, None], H, _NEG)
        # torch.argmax returns the first index on ties, as jnp.argmax.
        out += [torch.argmax(Hm, dim=0), torch.amax(Hm, dim=0)]
    return tuple(out)


def _check(H, masks):
    if H.dim() != 2:
        raise ValueError(f"H must be [S, O], got shape {tuple(H.shape)}")
    if H.dtype != torch.float64:
        raise TypeError(f"H must be float64, got {H.dtype}")
    if not H.is_contiguous():
        raise ValueError("H must be contiguous (row-major [S, O])")
    S = H.shape[0]
    if S == 0:
        raise ValueError("H must have at least one row")
    for m in masks:
        if m.dtype != torch.bool or m.dim() != 1 or m.shape[0] != S:
            raise ValueError(
                f"masks must be bool [{S}], got {m.dtype} {tuple(m.shape)}")
        if m.device != H.device:
            raise ValueError("masks and H must be on the same device")
        if not m.is_contiguous():
            raise ValueError("masks must be contiguous")


def triple_masked_argmax(H, base_mask, old_mask, new_mask, *, plan=None):
    """Returns (i_all, h_all, i_old, h_old, i_new, h_new), each [O]
    (indices int64, heights float64).  ``plan`` overrides ``split_plan``'s
    choice for a CUDA tensor (the tuning script tries others)."""
    global launches
    masks = (base_mask, old_mask, new_mask)
    _check(H, masks)
    if H.device.type == "cpu":
        return triple_masked_argmax_plain(H, *masks)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    S, O = H.shape
    if S >= 2 ** 31 or O >= 2 ** 31:
        raise ValueError("H is too large for the kernel's int indices")
    dev = H.device
    outs = []
    for _ in range(3):
        outs += [torch.empty(O, dtype=torch.int64, device=dev),
                 torch.empty(O, dtype=torch.float64, device=dev)]
    if O == 0:
        return tuple(outs)
    if plan is None:
        plan = split_plan(
            S, O, aligned=H.data_ptr() % 16 == 0,
            n_sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.blocks >= 2 ** 31:
        raise ValueError("H is too large for the kernel's grid")
    ws_shape = plan.workspace_shape(O)
    from stochasticdecomposition_torch.ops.kernels import library

    fn = library().sd_triple_masked_argmax
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = (torch.empty(ws_shape, dtype=torch.float64, device=dev),
              torch.empty(ws_shape, dtype=torch.int32, device=dev),
              torch.zeros(plan.n_otiles if ws_shape[0] else 0,
                          dtype=torch.int32, device=dev))
        err = fn(*(ptr(t.data_ptr()) for t in (H, *masks)), S, O,
                 plan.n_splits, int(plan.use_tma),
                 *(ptr(t.data_ptr()) for t in (*outs, *ws)), ptr(stream))
    if err != 0:
        raise RuntimeError(
            f"triple_masked_argmax kernel launch failed: error {err} (a "
            f"CUDA error; -1 a plan the kernel does not take, -2 no "
            f"cuTensorMapEncodeTiled, -1000-r the tensor map's CUresult r)")
    launches += 1
    return tuple(outs)
