"""The triple masked argmax of the SD cut: CUDA kernel, plain version,
launch counter.

For each column o of the height table H [S, O] and for each of three row
masks (all valid dual vertices, old ones, new ones) it returns the first
argmax and the max of ``where(mask[:, None], H, -1e300)`` over axis 0 —
what the JAX package's ``ops/pallas_argmax.py`` computes with its TPU kernel
and, off the TPU, with ``triple_masked_argmax_xla``.  The kernel
(``csrc/triple_argmax.cu``) selects in f64 and is bit-identical to the plain
version.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

_NEG = -1e300

# Kernel launches made by ``triple_masked_argmax`` (not by the plain
# version); a run resets it to 0 and reads it to show its path used the
# kernel.
launches = 0


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


def triple_masked_argmax(H, base_mask, old_mask, new_mask):
    """Returns (i_all, h_all, i_old, h_old, i_new, h_new), each [O]
    (indices int64, heights float64)."""
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
    outs = []
    for _ in range(3):
        outs += [torch.empty(O, dtype=torch.int64, device=H.device),
                 torch.empty(O, dtype=torch.float64, device=H.device)]
    if O == 0:
        return tuple(outs)
    from stochasticdecomposition_torch.ops.kernels import library

    fn = library().sd_triple_masked_argmax
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (H, *masks)),
                 S, O, *(ctypes.c_void_p(t.data_ptr()) for t in outs),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"triple_masked_argmax kernel launch failed: CUDA error {err}")
    launches += 1
    return tuple(outs)
