"""The native (C++) MPS core reader, bound with ctypes.

The port of the JAX package's ``smps/native.py``.  The package keeps its own
copy of the C++ source, ``native/smps_core.cpp``; ``g++ -O2 -shared -fPIC
-std=c++17`` builds it at first use (never at import) into
``_build/libsmps_core.so``, and again when the source is newer than the
library.  Ranks or test workers that build at once each write their own
file and rename it into place, so none loads a half-written library.

No fallback: when g++ is missing or fails, ``library()`` raises with its
error, and ``smps/core.read_core`` raises with it; the pure-Python parser
runs only when it is asked for (``prefer_native=False``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "smps_core.cpp"
LIB_PATH = _PKG / "_build" / "libsmps_core.so"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def build() -> float:
    """Compile the library if it is missing or older than the source;
    returns the seconds spent compiling (0.0 when it was up to date)."""
    if LIB_PATH.exists() and \
            LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return 0.0
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the native SMPS reader is built from "
            f"{SOURCE} with g++") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed: {' '.join(cmd)}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.monotonic() - t0


def library() -> ctypes.CDLL:
    """The loaded reader, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _declare(ctypes.CDLL(str(LIB_PATH)))
        return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp = ctypes.c_void_p
    lib.sd_parse_core.restype = vp
    lib.sd_parse_core.argtypes = [ctypes.c_char_p]
    lib.sd_core_error.restype = ctypes.c_char_p
    lib.sd_core_error.argtypes = [vp]
    for name in ("sd_core_nrows", "sd_core_ncols", "sd_core_nnz",
                 "sd_core_nranges"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [vp]
    lib.sd_core_obj_constant.restype = ctypes.c_double
    lib.sd_core_obj_constant.argtypes = [vp]
    for name in ("sd_core_name", "sd_core_objname", "sd_core_row_names",
                 "sd_core_col_names"):
        getattr(lib, name).restype = ctypes.c_char_p
        getattr(lib, name).argtypes = [vp]
    for name, ctyp in (
            ("sd_core_rhs", ctypes.c_double),
            ("sd_core_obj", ctypes.c_double),
            ("sd_core_lb", ctypes.c_double),
            ("sd_core_ub", ctypes.c_double),
            ("sd_core_mat_val", ctypes.c_double),
            ("sd_core_sense", ctypes.c_int8),
            ("sd_core_is_int", ctypes.c_uint8),
            ("sd_core_mat_row", ctypes.c_int32),
            ("sd_core_mat_col", ctypes.c_int32),
            ("sd_core_range_rows", ctypes.c_int32),
            ("sd_core_range_cols", ctypes.c_int32)):
        getattr(lib, name).restype = ctypes.POINTER(ctyp)
        getattr(lib, name).argtypes = [vp]
    lib.sd_free_core.restype = None
    lib.sd_free_core.argtypes = [vp]
    return lib


def read_core_native(path: str):
    """Parse an MPS core file with the C++ reader; the same
    ``CoreProblem`` as the pure-Python parser."""
    from stochasticdecomposition_torch.smps.core import CoreProblem

    lib = library()
    h = lib.sd_parse_core(os.fsencode(path))
    try:
        err = lib.sd_core_error(h)
        if err:
            raise ValueError(f"native SMPS parse error: {err.decode()}")
        m = int(lib.sd_core_nrows(h))
        n = int(lib.sd_core_ncols(h))
        nnz = int(lib.sd_core_nnz(h))

        def arr(fn, count, dtype):
            if count == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(fn(h), shape=(count,)).astype(
                dtype, copy=True)

        rows = arr(lib.sd_core_mat_row, nnz, np.int64)
        cols = arr(lib.sd_core_mat_col, nnz, np.int64)
        A = np.zeros((m, n))
        np.add.at(A, (rows, cols), arr(lib.sd_core_mat_val, nnz, np.float64))
        row_names = lib.sd_core_row_names(h).decode().split("\n") if m \
            else []
        col_names = lib.sd_core_col_names(h).decode().split("\n") if n \
            else []
        nr = int(lib.sd_core_nranges(h))
        range_slacks = [(int(a), int(b)) for a, b in zip(
            arr(lib.sd_core_range_rows, nr, np.int64),
            arr(lib.sd_core_range_cols, nr, np.int64))]
        return CoreProblem(
            name=lib.sd_core_name(h).decode(),
            objsense=1,
            obj_name=lib.sd_core_objname(h).decode(),
            row_names=row_names, col_names=col_names,
            row_index={r: i for i, r in enumerate(row_names)},
            col_index={c: i for i, c in enumerate(col_names)},
            A=A, b=arr(lib.sd_core_rhs, m, np.float64),
            sense=arr(lib.sd_core_sense, m, np.int32),
            c=arr(lib.sd_core_obj, n, np.float64),
            obj_constant=float(lib.sd_core_obj_constant(h)),
            lb=arr(lib.sd_core_lb, n, np.float64),
            ub=arr(lib.sd_core_ub, n, np.float64),
            is_integer=arr(lib.sd_core_is_int, n, np.uint8).astype(bool),
            range_slacks=range_slacks,
        )
    finally:
        lib.sd_free_core(h)
