"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/<name>.so csrc/<name>.cu

Libraries go to ``phylo_tpu_torch/_build/<hash of the sources>/`` (listed
in .gitignore), so an edited source is rebuilt and a fresh checkout
builds everything at first use.  ``build_all()`` starts one nvcc per
source at once.  Nothing is built or loaded when a module is imported:
the first CUDA launch triggers it.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.  ``LAUNCHES`` counts kernel launches by wrapper name:
a wrapper adds one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
SOURCES = ("rank_kernels", "expm_kernels", "resample_kernels",
           "twist_kernels", "wide_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = collections.Counter()
_LIBS = {}
_FNS = {}


def reset_launches():
    LAUNCHES.clear()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join("/usr/local/cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir():
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _lib_path(name):
    return os.path.join(build_dir(), name + ".so")


def build_all(names=SOURCES, verbose=False):
    """Compile every missing library, one nvcc per source, all started
    together.  Returns {name: seconds or 0.0 when cached}."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    times = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def lib(name):
    """The loaded ctypes library for csrc/<name>.cu (built on demand)."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]


def bind(name, fn, n_ptr, n_int):
    """ctypes function `fn` of library `name` taking n_ptr pointers then
    n_int ints then the stream (every pointer and the stream as
    c_void_p)."""
    key = (name, fn)
    if key not in _FNS:
        f = getattr(lib(name), fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FNS[key] = f
    return _FNS[key]


def check(code, what):
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {code}")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def require(t, what, dtype=None, ndim=None, shape=None):
    """Validate a tensor handed to a CUDA kernel: on the GPU, contiguous,
    of the given dtype / rank / shape."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.shape}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    return t
