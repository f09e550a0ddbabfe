"""Float scalar constants on a device, each built once.

``torch.tensor(c, device="cuda")`` copies one number from pageable host
memory to the card on every call: a blocking copy of its own, and an
operation a CUDA graph cannot capture.  ``scalar(c, dtype, device)``
makes the 0-dim tensor the first time a (value, dtype, device) is asked
for and hands out that tensor after, for the ``KEEP`` most recently
used.  The value is the same ``torch.tensor(c, dtype=dtype)`` would hold,
so every result is bit equal.  It is meant for float divisors (a CUDA
division by a Python float multiplies by the reciprocal): an integer
scalar is exact as a Python int and needs no constant.

The cached tensors are shared by every caller: read them, never write
them.  A constant found written in place (its version counter moved) or
made to require a gradient raises instead of being handed out.  A CUDA
graph reads its constants by address: ``recording()`` collects those a
capture reads, for the graph to hold while the cache may drop them.
"""

from __future__ import annotations

import collections
import contextlib

import torch

KEEP = 256

_CACHE: collections.OrderedDict = collections.OrderedDict()
_RECORDING: list = []


def _device(device) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def scalar(value, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The 0-dim tensor ``torch.tensor(value, dtype=dtype, device=device)``
    (``None``: the CPU), built once.  Floats are keyed by their bits, so
    -0.0 and 0.0 are two constants and a NaN is found again."""
    dev = _device(device)
    key = (value.hex() if isinstance(value, float) else value, dtype, dev)
    t = _CACHE.get(key)
    if t is None:
        # never an inference tensor: autograd saves divisors for backward
        with torch.inference_mode(False):
            t = torch.tensor(value, dtype=dtype, device=dev)
        _CACHE[key] = t
        if len(_CACHE) > KEEP:
            _CACHE.popitem(last=False)
    elif t._version or t.requires_grad:
        raise RuntimeError(f"the shared constant {value!r} ({dtype}, {dev}) "
                           "was written in place or made to require grad")
    else:
        _CACHE.move_to_end(key)
    for seen in _RECORDING:
        seen[id(t)] = t
    return t


@contextlib.contextmanager
def recording():
    """``with recording() as seen``: ``seen`` (a dict by ``id``) holds
    every constant ``scalar`` handed out inside the block."""
    seen: dict = {}
    _RECORDING.append(seen)
    try:
        yield seen
    finally:
        _RECORDING.pop()
