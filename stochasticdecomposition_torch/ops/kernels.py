"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` (``-gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v``)
and linked with ``-shared`` into one library with a plain C interface,
``_build/libsd_kernels.so`` inside the package, at first use (never at
import).  The library is rebuilt when a source is newer than it; the
compiler's output (``ptxas``'s registers, shared memory and spills per
kernel) is kept in ``_build/nvcc.log``.  It is loaded with ``ctypes``; each
wrapper passes tensor pointers and PyTorch's current stream as
``c_void_p``.  No ``-lcuda``: the TMA tensor map is encoded through the
runtime's driver entry point (``cudaGetDriverEntryPoint``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsd_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built from csrc/ with nvcc")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build() -> float:
    """Compile the library if it is missing or older than a source: one
    ``nvcc -c`` per source, all started together, then one link.  Returns
    the seconds spent compiling (0.0 when it was up to date)."""
    srcs = sources()
    if LIB_PATH.exists() and all(
            LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.monotonic()
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed, log = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"{' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(log[-1])
    LOG_PATH.write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"libsd_kernels.{tag}.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    for obj in objs:
        obj.unlink()
    return time.monotonic() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = lib.sd_triple_masked_argmax
        fn.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 10
        fn.restype = ci
        _lib = lib
    return _lib
