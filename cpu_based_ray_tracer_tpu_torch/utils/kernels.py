"""Device choice, and the build and load of the hand-written CUDA kernels.

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


def tickets(n: int, stream) -> torch.Tensor:
    """n zero tickets for a split sweep's launch on ``stream``, from a
    buffer kept for the stream (the launches on one stream run one after
    another, and each leaves its tickets zero)."""
    key = (stream.device.index, stream.cuda_stream)
    buf = TICKETS.get(key)
    if buf is None or buf.shape[0] < n:
        buf = TICKETS[key] = torch.zeros((n,), dtype=torch.int32,
                                         device=stream.device)
    return buf
