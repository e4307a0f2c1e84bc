"""SMPS (core/time/stoch) frontend.

Replacement for the spAlgorithms SMPS reader used by the reference
(``readCore/readTime/readStoc`` at twoSD.c:256-279).  The core file is
tokenized by native C++ (``smps/native.py``), the time and stoch files in
Python; the result is staged into static-shape arrays by
``stochasticdecomposition_torch.prob``.
"""

from stochasticdecomposition_torch.smps.core import CoreProblem, read_core  # noqa: F401
from stochasticdecomposition_torch.smps.timefile import TimeData, read_time  # noqa: F401
from stochasticdecomposition_torch.smps.stoc import (  # noqa: F401
    StocData, RandomElement, read_stoc,
)


def read_smps(input_dir, prob_name):
    """Read the SMPS triplet ``<prob>.cor/.tim/.sto`` (reference: twoSD.c:256-279)."""
    import os

    def _find(exts):
        for ext in exts:
            p = os.path.join(input_dir, prob_name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"none of {exts} found for {prob_name} in {input_dir}")

    core = read_core(_find([".cor", ".core", ".mps"]))
    tim = read_time(_find([".tim", ".time"]), core)
    stoc = read_stoc(_find([".sto", ".stoc", ".stoch"]), core)
    return core, tim, stoc
