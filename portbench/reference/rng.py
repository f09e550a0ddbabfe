"""The counter-based random numbers the renderers draw: the pcg4d hash
(Jarzynski and Olano 2020, eq. 19) of (pixel, sample, bounce * 8 + stream,
seed word), each u32 output turned into a float in [0, 1) from its top 24
bits.  The hash runs in int64 holding u32 values, masked after every
operation."""

from __future__ import annotations

import torch

JITTER, SCATTER, LIGHT = 0, 2, 4
N_STREAMS = 8
_MASK = 0xFFFFFFFF


def _u32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def pcg4d(a, b, c, d):
    mul, inc = 1664525, 1013904223
    a = (a * mul + inc) & _MASK
    b = (b * mul + inc) & _MASK
    c = (c * mul + inc) & _MASK
    d = (d * mul + inc) & _MASK
    a = (a + b * d) & _MASK
    b = (b + c * a) & _MASK
    c = (c + a * b) & _MASK
    d = (d + b * c) & _MASK
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + b * d) & _MASK
    b = (b + c * a) & _MASK
    c = (c + a * b) & _MASK
    d = (d + b * c) & _MASK
    return a, b, c, d


def uniforms4(seed: int, pixel, sample, bounce, stream: int,
              dtype=torch.float32):
    """Four U[0, 1) draws per lane, (R,) each, in ``dtype`` (computed in
    float32 and then converted)."""
    dev = pixel.device
    pixel = _u32(pixel, dev)
    ctr = (_u32(bounce, dev) * N_STREAMS + stream) & _MASK
    out = pcg4d(pixel, _u32(sample, dev), ctr, _u32(seed, dev))
    return tuple(((x.expand(pixel.shape) >> 8).to(torch.float32)
                  * (1.0 / (1 << 24))).to(dtype) for x in out)
