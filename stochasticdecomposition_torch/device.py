"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
name.  Without a card and without that request they raise: a run never
quietly moves to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` (or a CPU device) must be
    asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
