"""Stable stream compaction (port of ``cpu_based_ray_tracer_tpu.ops.compact``).

The JAX package packs lanes inside its TPU kernels with binary funnel
shifts, because Mosaic has no cumsum and no gather.  Here the same
functions are plain PyTorch: an exclusive prefix sum, then indexing.  The
semantics are those of the JAX helpers:

- ``tile_prefix_pos``: exclusive prefix sum of a 0/1 mask in row-major
  flattened order;
- ``funnel_pack``: the lanes where the mask is set move to the front, in
  lane order; returns the packed planes and their ``count``;
- ``funnel_unpack``: the inverse, each of the first elements moves to its
  target lane; returns the planes and the ``landed`` mask.

Where the JAX helpers leave garbage (lanes past ``count`` after a pack,
lanes nothing landed on after an unpack), these return zeros.  The engine
does not call them: the CUDA kernels of ``ops.fused_mesh`` pack with a
block-level ballot prefix, and their plain versions gather the lanes of
``pred.nonzero()``, which is ``funnel_pack`` without its zero tail.
"""

from __future__ import annotations

import torch


def tile_prefix_pos(pred: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of the row-major flattened 0/1 mask, shaped
    like ``pred`` (int32)."""
    flat = pred.reshape(-1).to(torch.int64)
    return (torch.cumsum(flat, 0) - flat).to(torch.int32).reshape(pred.shape)


def funnel_pack(planes, pred: torch.Tensor):
    """Pack the lanes where ``pred`` to the flattened front of each plane
    (all shaped like ``pred``), keeping lane order.  Returns
    ``(packed_planes, count)``; lanes ``>= count`` hold zeros."""
    keep = pred.reshape(-1) != 0
    pos = tile_prefix_pos(pred).reshape(-1)[keep].to(torch.int64)
    out = []
    for x in planes:
        y = torch.zeros_like(x).reshape(-1)
        y[pos] = x.reshape(-1)[keep]
        out.append(y.reshape(x.shape))
    return out, int(pos.numel())


def funnel_unpack(planes, target: torch.Tensor, valid: torch.Tensor):
    """Inverse of ``funnel_pack``: element i of each plane (flattened order,
    where ``valid``) moves to lane ``target[i]`` of an output shaped like
    ``target``.  Targets of the valid elements are distinct.  Returns
    ``(unpacked_planes, landed)``: ``landed`` (int32) marks the lanes that
    received an element; the other lanes hold zeros."""
    sel = valid.reshape(-1) != 0
    tgt = target.reshape(-1)[sel].to(torch.int64)
    landed = torch.zeros(target.numel(), dtype=torch.int32,
                         device=target.device)
    landed[tgt] = 1
    out = []
    for x in planes:
        y = torch.zeros(target.numel(), dtype=x.dtype, device=x.device)
        y[tgt] = x.reshape(-1)[sel]
        out.append(y.reshape(target.shape))
    return out, landed.reshape(target.shape)
