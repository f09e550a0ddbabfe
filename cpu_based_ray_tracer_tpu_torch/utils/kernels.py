"""Device choice, the build and load of the hand-written CUDA kernels, and
the one seam through which the kernel wrappers call them.

Every ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions returning the ``cudaError_t`` of ``cudaGetLastError()``).  At
first use it is compiled with ``nvcc`` into ``build/torch_kernels/`` at the
root of the checkout (a directory ``.gitignore`` lists), under a name that
carries a hash of the source, the headers beside it (``csrc/*.cuh``) and
the flags, and loaded with ``ctypes``.

Flags: ``-fmad=false`` keeps ``a*b+c`` as two rounded operations, as the
JAX package computes it, so knife-edge hits and the integer lane state
match the plain PyTorch versions; no ``--use_fast_math`` (IEEE division and
square root, full-precision ``cosf``/``sinf``).

The seam: a wrapper declares its library once (``Library``: the entry
points' signatures and the launch counter), checks its tensors with
``check`` and launches with ``Library.launch`` on ``stream``'s handle.
``Library.occupancy`` asks a kernel's resident blocks once per device and
arguments; ``tickets`` keeps the split sweeps' zeroed tickets per stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from cpu_based_ray_tracer_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# (device index, stream) -> the split sweeps' tickets, zero between
# launches (a kernel's last block of a ray block sets its ticket back to 0).
TICKETS: dict = {}
_lock = threading.Lock()
# name -> the compiler's report (ptxas registers / spills) of the last build
BUILD_LOG: dict[str, str] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  There is no fallback: asking for CUDA on a
    machine without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); nvcc is needed "
                           "to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}.{h.hexdigest()[:12]}.so")


def build(names) -> None:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Raises with the compiler's output if one
    fails."""
    targets = {name: _target(name) for name in names}
    todo = [n for n, (_, out) in targets.items() if not os.path.isfile(out)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs, failed = {}, []
    with profiling.span("kernels.build"):
        for name in todo:
            src, out = targets[name]
            tmp = f"{out}.{os.getpid()}.tmp"   # renamed into place when built
            procs[name] = (out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (out, tmp, p) in procs.items():
            log, _ = p.communicate()
            BUILD_LOG[name] = log
            if p.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_target(name)[1])
        return lib


def stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def tickets(n: int, device) -> torch.Tensor:
    """n zero tickets for a split sweep's launch on the current stream of
    ``device``, from a buffer kept for the stream (the launches on one
    stream run one after another, and each leaves its tickets zero)."""
    s = torch.cuda.current_stream(device)
    key = (s.device.index, s.cuda_stream)
    buf = TICKETS.get(key)
    if buf is None or buf.shape[0] < n:
        buf = TICKETS[key] = torch.zeros((n,), dtype=torch.int32,
                                         device=s.device)
    return buf


def check(kernel: str, tensors: dict) -> None:
    """Each ``what: (tensor, dtype)`` of ``tensors`` a contiguous CUDA
    tensor of that dtype, or ValueError naming ``kernel`` and ``what``."""
    for what, (x, dt) in tensors.items():
        if not (isinstance(x, torch.Tensor) and x.is_cuda and x.dtype == dt
                and x.is_contiguous()):
            raise ValueError(f"{kernel} takes contiguous CUDA {dt} tensors; "
                             f"{what} is not one")


class Library:
    """The C entry points of ``csrc/<name>.cu``.  ``signatures``: entry ->
    its ctypes argument types (every entry returns a ``cudaError_t`` as
    int); ``launches``: the ``profiling.Counter`` that counts them.  The
    library is built, loaded and its signatures bound at the first call."""

    def __init__(self, name: str, signatures: dict,
                 launches: profiling.Counter):
        self.name = name
        self.signatures = signatures
        self.launches = launches
        self._fns: dict | None = None
        self._occupancy: dict = {}

    def _fn(self, entry: str):
        if self._fns is None:
            lib = load(self.name)
            fns = {}
            for e, argtypes in self.signatures.items():
                fn = getattr(lib, e)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[e] = fn
            self._fns = fns
        return self._fns[entry]

    def launch(self, entry: str, *args, key: str | None = None) -> None:
        """Call ``entry`` (a launch on the stream among ``args``); a
        non-zero cudaError raises RuntimeError, else the launch counts
        under ``key`` (default: the counter's one count)."""
        rc = self._fn(entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
        self.launches.add(key)

    def occupancy(self, entry: str, *args) -> tuple[int, int]:
        """(resident blocks per SM, SMs) that the query ``entry(*args,
        out)`` reports for the current card, asked once per device and
        args."""
        key = (entry, torch.cuda.current_device(), args)
        got = self._occupancy.get(key)
        if got is None:
            out = (ctypes.c_int * 2)()
            rc = self._fn(entry)(*args, ctypes.addressof(out))
            if rc != 0:
                raise RuntimeError(f"{entry} failed: cudaError {rc}")
            got = self._occupancy[key] = (out[0], out[1])
        return got
