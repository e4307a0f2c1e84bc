"""Two-stage Stochastic Decomposition (2-SD) in PyTorch, for CUDA cards.

The port of the JAX package ``stochasticdecomposition_tpu`` (the reference,
which stays as it is).  It mirrors that package's module layout, imports
nothing of it, and runs Higle & Sen's sequential-sampling SD — plain
randomness, QP master, one observation per iteration — on the card, with the
argmax cut procedure as a CUDA kernel (``ops/argmax.py``,
``csrc/triple_argmax.cu``).
"""

__version__ = "0.1.0"

from stochasticdecomposition_torch.config import SDConfig, load_config  # noqa: F401
