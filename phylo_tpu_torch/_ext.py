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
a wrapper adds one where it launches its kernel, and nowhere else.  A
CUDA graph's replay runs no Python, so ``CountedGraph`` keeps the counts
its capture recorded (a capture launches nothing) and adds them at each
replay.
"""

from __future__ import annotations

import collections
import contextlib
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
           "twist_kernels", "wide_kernels", "twist_wide_kernels",
           "eigh_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = collections.Counter()
_LIBS = {}
_FNS = {}
_CAPTURE_STREAMS = {}


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


def new_graph():
    """The graph object a CountedGraph captures into (a stand-in replaces
    this in the CPU tests)."""
    return torch.cuda.CUDAGraph()


@contextlib.contextmanager
def _capture_stream(device):
    """A capture's stream: one side stream a card, entered after the
    device is idle and the allocator's cached blocks are released, so the
    graph's pool can take that memory (as torch.cuda.graph does), and
    left with the device idle again; nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(_CAPTURE_STREAMS[device]):
        yield
    torch.cuda.synchronize(device)


class CountedGraph:
    """A CUDA graph of one callable, with the kernel launches of its
    capture.  `generators` are registered with the graph before capture,
    so each replay draws from their (seed, offset) as an eager call would
    (reseed one with manual_seed before a replay); `pool` is another
    graph's memory pool to share.  A failed capture or replay raises."""

    def __init__(self, device, generators=(), pool=None):
        self.device = torch.device(device)
        self.graph = new_graph()
        self.generators = tuple(generators)
        self.pool = pool
        self.launches = collections.Counter()
        self.replays = 0
        self.capture_seconds = 0.0

    def capture(self, fn, reset=None):
        """Run fn() once eagerly, then capture it, both on the capture
        stream: the eager call is the warm-up (it builds, loads and binds
        the kernels and makes their per-stream state, such as K4's
        ticket, outside the graph's pool).  reset() runs between the two,
        and the blocks the eager call freed go back to the card, so the
        graph's pool does not sit beside the eager call's cache (two
        copies of a pair chunk's transitions, VNCSMC GY94+G4's ~20 GB
        each).  Returns (the eager call's value, the graph's static
        outputs); LAUNCHES counts the eager call and not the capture."""
        for g in self.generators:
            self.graph.register_generator_state(g)
        with _capture_stream(self.device):
            out = fn()
            if reset is not None:
                reset()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
            before = collections.Counter(LAUNCHES)
            t0 = time.perf_counter()
            try:
                self.graph.capture_begin(pool=self.pool)
                try:
                    static = fn()
                finally:
                    self.graph.capture_end()
            finally:
                self.launches = LAUNCHES - before
                LAUNCHES.clear()
                LAUNCHES.update(before)
            self.capture_seconds = time.perf_counter() - t0
        return out, static

    def replay(self):
        self.graph.replay()
        LAUNCHES.update(self.launches)
        self.replays += 1


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
