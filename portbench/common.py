"""Small pieces every part of the benchmark shares: the request seeds, the
percentile, the reservoir of checked requests, a compared number, and the
estimator settings a configuration states."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import random


def request_seed(seed: int, i: int) -> int:
    """The u32 seed word of request ``i`` of a run with ``--seed seed``
    (any integer): the first four bytes of SHA-256 of "seed/i"."""
    digest = hashlib.sha256(f"{int(seed)}/{int(i)}".encode()).digest()
    return int.from_bytes(digest[:4], "little")


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between the closest
    ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Reservoir:
    """A uniform sample of at most ``k`` of the requests offered, drawn
    from ``seed`` (reservoir sampling): ``slot(i)`` says, before request
    ``i`` runs, where to keep it (None: not kept)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(request_seed(seed, -7))
        self.items: dict = {}

    def slot(self, i: int):
        if i < self.k:
            return i
        j = self.rng.randint(0, i)
        return j if j < self.k else None

    def keep(self, slot, item) -> None:
        if slot is not None:
            self.items[slot] = item

    def kept(self) -> list:
        return [self.items[s] for s in sorted(self.items)]


@dataclasses.dataclass
class Check:
    """One number compared with its limit: the run is correct only where
    ``value <= limit`` (a NaN fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


def estimator_settings(config: dict) -> dict:
    """The estimator settings the configuration states, under the names
    that both the program's ``RenderConfig`` and the reference's
    ``mc.Settings`` take."""
    return {k: config[k] for k in ("rr_survival", "t_min",
                                   "shadow_tolerance")}


TOL = 2e-3      # the Monte Carlo radiance tolerance, absolute and relative


def share_off(got, want) -> float:
    """The share of pixels (rows of (..., 3)) with some channel off by more
    than TOL + TOL * |want|, or not finite in one of the two."""
    import torch

    got = got.reshape(-1, got.shape[-1]).to(torch.float32)
    want = want.reshape(-1, want.shape[-1]).to(torch.float32)
    err = (got - want).abs()
    bad = ~(err <= TOL + TOL * want.abs())
    return float(bad.any(1).to(torch.float64).mean())
