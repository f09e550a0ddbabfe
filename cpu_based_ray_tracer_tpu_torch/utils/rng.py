"""Counter-based RNG: the pcg4d hash (port of ``cpu_based_ray_tracer_tpu.utils.rng``).

Random draws are a pure function of (pixel index, sample index,
bounce * N_STREAMS + stream, seed word), bit-identical to the JAX package.

The JAX package derives the seed word from a ``jax.random`` key
(``seed_from_key(render_key(k))``); every entry point of this package takes
the u32 word itself as a plain ``int``, and ``seed_word(k)`` computes the
word JAX derives from the integer seed ``k`` (its default threefry2x32
key and ``random.bits``), so a ``--seed k`` of either package's CLI draws
the same samples.

The hash runs in int64 holding u32 values: CPU builds of PyTorch do not
implement ``+`` and ``>>`` for ``torch.uint32``.  An int64 product of two
u32 values may wrap past 2**63, which leaves its low 32 bits intact, and
every result is masked back to 32 bits before the next shift.
"""

from __future__ import annotations

import torch

# Stream tags: independent random decisions within one (pixel, sample, bounce).
JITTER = 0        # in-pixel MSAA jitter
LENS = 1          # thin-lens aperture sample
SCATTER = 2       # BSDF direction sample
RR = 3            # Russian-roulette coin
LIGHT = 4         # area-light sample
SCHLICK = 5       # dielectric reflect-vs-refract coin
N_STREAMS = 8

_MASK = 0xFFFFFFFF


def as_u32(x, device=None):
    """An int tensor -> int64 tensor holding its u32 bit pattern; an int ->
    the Python int of its u32 pattern (the hash's arithmetic is exact on
    it, and it takes no copy to the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=torch.int64) & _MASK
    return int(x) & _MASK


def _mul(x, y):
    """The product of two u32 values, int64 tensors or Python ints: an
    int64 product wraps past 2**63, keeping its low 32 bits, and one of two
    ints is cut to those bits, so that it fits the int64 of a tensor op."""
    if isinstance(x, int) and isinstance(y, int):
        return (x * y) & _MASK
    return x * y


def pcg4d(a, b, c, d):
    """pcg4d hash: 4 x u32 in -> 4 x u32 out (Jarzynski-Olano eq. 19).

    Inputs and outputs are int64 tensors or Python ints holding u32 values
    (``as_u32``); an output is a tensor where a tensor entered it."""
    mul, inc = 1664525, 1013904223
    a = (a * mul + inc) & _MASK
    b = (b * mul + inc) & _MASK
    c = (c * mul + inc) & _MASK
    d = (d * mul + inc) & _MASK
    a = (a + _mul(b, d)) & _MASK
    b = (b + _mul(c, a)) & _MASK
    c = (c + _mul(a, b)) & _MASK
    d = (d + _mul(b, c)) & _MASK
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul(b, d)) & _MASK
    b = (b + _mul(c, a)) & _MASK
    c = (c + _mul(a, b)) & _MASK
    d = (d + _mul(b, c)) & _MASK
    return a, b, c, d


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011), as
    ``jax.random``'s default PRNG applies it."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & _MASK

    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def seed_word(seed: int) -> int:
    """The u32 word ``seed_from_key(render_key(seed))`` of the JAX package:
    ``jax.random.key(seed)`` is the threefry key (seed >> 32, seed & M) and
    one u32 of ``jax.random.bits`` is the xor of the cipher's two output
    words at counter (0, 0)."""
    seed = int(seed)
    y0, y1 = _threefry2x32((seed >> 32) & _MASK, seed & _MASK, 0, 0)
    return y0 ^ y1


def _to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """u32 -> float32 uniform in [0, 1) using the top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniforms4(seed, pixel, sample, bounce, stream: int):
    """Four independent U[0,1) draws per lane.

    seed: u32 word (int or 0-dim tensor); pixel: (R,) absolute pixel index;
    sample, bounce: scalars or (R,) per-lane indices; stream: a tag above.
    Returns a tuple of 4 float32 tensors shaped like ``pixel``."""
    pixel = as_u32(pixel)
    dev = pixel.device
    ctr = (as_u32(bounce, dev) * N_STREAMS + stream) & _MASK
    a, b, c, d = pcg4d(pixel, as_u32(sample, dev), ctr, as_u32(seed, dev))
    return tuple(_to_unit_float(x.expand(pixel.shape)) for x in (a, b, c, d))
