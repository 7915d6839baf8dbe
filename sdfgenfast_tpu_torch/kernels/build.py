"""Build and load the package's hand-written CUDA kernels.

The sources are ``sdfgenfast_tpu_torch/csrc/*.cu`` (sharing device code
through ``csrc/*.cuh``), each a kernel plus a plain C entry point that
launches it on a given stream and returns ``cudaGetLastError()``. Each source is compiled by its own ``nvcc`` process,
all started together, for Hopper (``sm_90a``); the objects are linked into
one shared library loaded through ``ctypes``. Nothing includes PyTorch's
headers, so a build takes seconds.

The library lands in ``build/sdfgenfast_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds on
next use. Nothing here runs at import time: the first kernel launch (or an
explicit :func:`library` call) builds and loads.

Each of the program's kernel wrappers registers where it is defined
(:func:`counted`): its ``.launches`` counter joins :data:`COUNTED`, which
``tracing.launch_count`` sums.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "sdfgenfast_tpu_torch")

# no fast math: IEEE sqrt and division; --fmad=false keeps every product and
# sum rounded on its own, like the PyTorch twins' separate elementwise ops
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-O3", "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_longlong)
# C entry points and their argument types (pointers and the stream as void*,
# a value written back as int* or long long*)
_SIGNATURES = {
    "sdf_band_coefs": [_P, _I, _P, _P],
    "sdf_band_rows": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                      _P, _P, _P, _P, _P, _P],
    "sdf_vdt_round": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "sdf_chamfer": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    "sdf_dense_stream": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "sdf_dense_stream_counted": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P,
                                 _P, _P],
    "sdf_sep_table": [_P, _I, _P, _I, _P, _P, _P],
    "sdf_parity_sign": [_P, _I, _I, _P, _P, _I, _I, _I, _P],
    "sdf_recompute_terms": [_P, _I, _P, _P],
    "sdf_recompute_phi": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F,
                          _F, _F, _F, _I, _I, _I, _P, _P],
    "sdf_recompute_vjp": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _F,
                          _F, _L, _I, _P, _P],
    "sdf_recompute_vjp_rows": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F,
                               _F, _F, _F, _L, _I, _I, _I, _P, _P, _P, _P,
                               _P],
    "sdf_probe_vpu_peak": [_P, _P, _L, _I, _I, _P],
    "sdf_probe_vpu_mixed": [_P, _P, _L, _I, _P],
    "sdf_probe_scale2": [_P, _P, _L, _L, _I, _I, _L, _P],
    "sdf_probe_add1": [_P, _P, _L, _L, _I, _I, _L, _P],
    "sdf_probe_tile_plan": [_I, _L, _I, _LP, _IP, _IP],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

COUNTED: list = []  # the program's kernel wrappers, in import order


def counted(fn):
    """Register kernel wrapper `fn` (a decorator): its ``fn.launches``
    counter starts at 0 and joins :data:`COUNTED`."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


class KernelBuildError(RuntimeError):
    pass


def sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels need the "
                               "CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libsdfgenfast_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. The compiler's register/shared-memory report goes to
    ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources(), objs)]
    log, failed = [], []
    procs = []
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate(timeout=600)
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
        if not failed:
            tmp = f"{path}.{tag}"
            cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
            if r.returncode != 0:
                failed.append(f"link ({r.returncode}):\n{r.stderr[-4000:]}")
            else:
                os.replace(tmp, path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(path + ".log", "w") as fh:
            fh.write("\n".join(log))
    if failed:
        raise KernelBuildError("nvcc failed: " + "\n".join(failed))
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
