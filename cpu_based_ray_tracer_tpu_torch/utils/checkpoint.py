"""Checkpoint / resume (port of ``cpu_based_ray_tracer_tpu.utils.checkpoint``).

- ``save_render_state`` / ``load_render_state``: the progressive-render
  triple (accumulated radiance, samples done, u32 seed word) and a hash of
  the ``RenderConfig`` that refuses to resume across configs.  The ``.npz``
  layout and the hash are the JAX package's (the two ``RenderConfig``
  classes have the same fields), so a state saved by either package
  resumes in the other;
- ``save_pytree`` / ``load_pytree``: any nest of dataclasses (the port's
  ``Scene``, a camera), dicts, tuples and lists of tensors or arrays (an
  optimizer's state) to one ``.npz``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def config_hash(cfg) -> str:
    payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_render_state(path, accum, samples_done: int, seed: int, cfg) -> None:
    np.savez_compressed(
        path, accum=_numpy(accum), samples_done=np.asarray(samples_done),
        seed=np.asarray(int(seed) & 0xFFFFFFFF, np.uint32),
        config_hash=np.asarray(config_hash(cfg)))


def load_render_state(path, cfg, device=None):
    """-> (accum tensor on ``device`` (default: the card), samples_done,
    seed word).  Raises ValueError when the saved state was produced under
    another RenderConfig."""
    dev = resolve_device(device)
    with np.load(path) as z:
        saved = str(z["config_hash"])
        if saved != config_hash(cfg):
            raise ValueError(
                f"checkpoint config hash {saved} != current "
                f"{config_hash(cfg)} — refusing to resume")
        return (torch.from_numpy(z["accum"]).to(dev), int(z["samples_done"]),
                int(z["seed"]))


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` depth first; return its structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ",".join(f"{k!r}:{_flatten(tree[k], leaves)}"
                              for k in keys) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(x, leaves) for x in tree)
        return f"{type(tree).__name__}({inner})"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = ",".join(f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                         for f in dataclasses.fields(tree))
        return f"{type(tree).__name__}({inner})"
    leaves.append(tree)
    return "*"


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, it) for x in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return next(it)


def save_pytree(path, tree) -> None:
    leaves: list = []
    treedef = _flatten(tree, leaves)
    np.savez_compressed(
        path, __treedef__=np.asarray(treedef),
        **{f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)})


def load_pytree(path, like):
    """Restore the leaves saved by ``save_pytree`` into the structure of
    ``like`` (its structure must match): a leaf that is a tensor in
    ``like`` comes back as a tensor on that tensor's device, any other as a
    numpy array."""
    leaves: list = []
    treedef = _flatten(like, leaves)
    with np.load(path) as z:
        if str(z["__treedef__"]) != treedef:
            raise ValueError("pytree structure mismatch")
        saved = [z[f"leaf_{i}"] for i in range(len(leaves))]
    out = [torch.from_numpy(np.array(a)).to(x.device)
           if isinstance(x, torch.Tensor) else a
           for a, x in zip(saved, leaves)]
    return _unflatten(like, iter(out))
