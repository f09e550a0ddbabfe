"""A differentiable function of tensors replayed as CUDA graphs.

The scheme of ``torch.cuda.make_graphed_callables``: the function's
forward is captured into one CUDA graph and its backward (everything
``torch.autograd.grad`` runs for it, a checkpoint's recomputation
included) into a second, both in one memory pool, and a call copies its
inputs into the graphs' static inputs and replays one graph launch in
place of every operation's own.  The function itself is unchanged.

``GraphCache(counter)`` keeps the captures per key (the caller's key, and
each input's shape, dtype, device and whether it requires grad), the
``KEEP`` most recently used (a capture holds a memory pool).  A key's
first call runs the function eagerly: a caller that never repeats a key
pays no capture, and that call is the warm-up of the lazy initialisation
a capture must not see.  Its second call captures, and replays; every
later one replays.  It counts into ``counter`` (a ``profiling.Counter``
with the keys ``captures``, ``replays``, ``eager``).

What a capture needs of the function: no read of the device by the host
and no copy from pageable host memory (both fail the capture loudly), the
same operations on every call with the same key, and every tensor it
reads either an input or held by the capture (the constants of
``utils.consts`` it reads are).  A replay overwrites the previous
replay's static output, activations and gradients: the output is handed
out as a clone and the gradients as clones, and while a replay's
backward is still to come, a second call with its key runs the function
eagerly instead.  A backward replays once: ``retain_graph`` and a second
backward raise.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.autograd.function import once_differentiable

from cpu_based_ray_tracer_tpu_torch.utils import consts

KEEP = 4
SEEN = 64


class _Token:
    """Alive while a replay's backward may still run (held by its ctx)."""


class _Capture:
    """The two graphs of one key and their static tensors."""

    def __init__(self, fn, inputs, requires_grad):
        self.static_in = [x.detach().clone().requires_grad_(r)
                          for x, r in zip(inputs, requires_grad)]
        self.diff = [i for i, r in enumerate(requires_grad) if r]
        self.waiting = weakref.WeakSet()
        pool = torch.cuda.graph_pool_handle()
        with consts.recording() as self.consts:
            self.fwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.fwd, pool=pool):
                out = fn(*self.static_in)
            self.bwd = None
            if self.diff:
                self.grad_out = torch.empty_like(out)
                self.bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.bwd, pool=pool):
                    self.grads = torch.autograd.grad(
                        out, [self.static_in[i] for i in self.diff],
                        self.grad_out, allow_unused=True)
        self.out = out.detach()
        torch.cuda.synchronize()


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap, *inputs):
        for s, x in zip(cap.static_in, inputs):
            s.copy_(x)
        cap.fwd.replay()
        if cap.bwd is not None:
            ctx.cap, ctx.token = cap, _Token()
            cap.waiting.add(ctx.token)
        return cap.out.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        cap = ctx.cap
        if ctx.token not in cap.waiting:
            raise RuntimeError("a graphed replay's backward runs once "
                               "(its activations are the graph's own)")
        cap.waiting.discard(ctx.token)
        cap.grad_out.copy_(grad)
        cap.bwd.replay()
        grads = [None] * len(cap.static_in)
        for i, g in zip(cap.diff, cap.grads):
            grads[i] = None if g is None else g.clone()
        return (None, *grads)


class GraphCache:
    """``cache(key, fn, inputs)`` = ``fn(*inputs)``: eager at the first
    call of (``key``, the inputs' signature), captured at the second,
    replayed after.  The inputs lie on one CUDA device."""

    def __init__(self, counter):
        self.counter = counter
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._captures: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, key, fn, inputs):
        grad = torch.is_grad_enabled()
        requires_grad = tuple(grad and x.requires_grad for x in inputs)
        key = (key, requires_grad,
               tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
        cap = self._captures.get(key)
        first = cap is None and self._seen.pop(key, None) is None
        if first:
            self._seen[key] = True
            while len(self._seen) > SEEN:
                self._seen.popitem(last=False)
        if first or (cap is not None and cap.waiting):
            self.counter.add("eager")
            return fn(*inputs)
        with torch.cuda.device(inputs[0].device):
            if cap is None:
                cap = _Capture(fn, inputs, requires_grad)
                self.counter.add("captures")
                self._captures[key] = cap
                while len(self._captures) > KEEP:
                    self._captures.popitem(last=False)
            self._captures.move_to_end(key)
            self.counter.add("replays")
            return _Replay.apply(cap, *inputs)

    def clear(self) -> None:
        self._seen.clear()
        self._captures.clear()
