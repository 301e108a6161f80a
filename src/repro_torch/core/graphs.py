"""Captured CUDA graphs: the torch form of ``jax.jit``'s executable cache,
for the fused round engine (``core/api.py`` ``FusedEngine``), the serving
loop's decode step (``serving/loop.py``) and the sLSTM recurrence
(``models/xlstm.py``). It has no counterpart in the JAX package.

A :class:`GraphSet` belongs to one owner (a round runner, a serving loop,
the sLSTM recurrence on one device). It owns one graph memory pool and
one capture stream, shared by every graph it captures, and hands out
:class:`Captured` callables, one per function (the fused round, the chunk
epochs, the finalize; the decode step). A ``Captured`` keeps one graph
per key; the key is the layout of the arguments (tree paths, shapes,
strides, dtypes, devices), as ``jax.jit``'s cache key is their abstract
values.

Arguments come in two kinds:

* bound arguments (the state's params, optimizer state and residual, the
  last shared model, the static scalar buffers of the schedule, the
  mixing matrix): a graph reads and writes their storage by address.
  Every call compares the addresses with those the graph was captured on,
  and a graph is never replayed on other storage: a changed address (a
  new ``learner.init``, a rebound state) captures again, and is counted.
* copied inputs (positions named by ``inputs=``: the round's staged
  batches): the first call keeps the given tensors as the graph's static
  inputs, later calls copy into them. With ``own_inputs=True`` the first
  call keeps clones instead, for inputs that are views of storage the
  caller keeps (one layer's slice of stacked params): later calls then
  never write into the caller's tensors.

``limit=`` caps a function's captures: a call that would capture beyond
it raises :class:`RecaptureError` (an ``analysis.guards.RetraceError``)
before capturing, and the graphs already held stay as they were;
``analysis.guards.no_retrace`` wraps a ``Captured`` with the same budget
from outside (``Captured.would_capture``).

On the card the first call of a key captures. The set's first capture
runs the function eagerly on the capture stream first — that run is the
call's real work and the warm-up that capture needs (cuBLAS workspaces,
the autograd engine, lazily loaded kernels) — and only records it for
later calls; every later capture records and replays at once. Later calls
copy the inputs and replay. A call returns the graph's static outputs,
which its next replay overwrites, and the pool is shared: the caller
reads or clones a graph's outputs before any graph of the set replays
again, and keeps every result that must outlive a replay in storage
allocated outside capture. A failed capture raises; nothing falls back to
running eagerly.

On the CPU (only when the caller asked for it) nothing is captured: each
call runs the function on the static inputs, and ``captures`` counts the
keys first run — what the card would capture.

The kernel launch counters (``kernels/ops.py``) count on the host when a
wrapper is called, which under capture is recording, not launching. A
capture takes the launches it recorded back out of the counters and keeps
them with the graph; every replay adds them again, so
``ops.launch_counts()`` counts the launches made.

``GraphSet.no_sync()`` is the round's guard, ``analysis.guards.
no_transfer`` on the set's device: inside it, on the card, any host
synchronisation raises (``torch.cuda.set_sync_debug_mode("error")``),
except while a graph is being captured (a capture synchronises) and inside
``allow_sync()``.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from repro_torch.analysis.guards import RetraceError, no_transfer
from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, leaves_with_path, tree_map


class RecaptureError(RetraceError):
    """A captured function would capture more graphs than its limit."""


def _layout(args):
    return tuple(
        None if a is None else tuple(
            (path, tuple(t.shape), t.stride(), t.dtype, t.device)
            for path, t in leaves_with_path(a))
        for a in args)


def _ptrs(args):
    return tuple(t.data_ptr() for a in args for t in leaves(a))


@contextlib.contextmanager
def allow_sync():
    """Lift the sync guard inside a ``GraphSet.no_sync()`` window."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Graph:
    __slots__ = ("graph", "ptrs", "inputs", "outputs", "launches")

    def __init__(self, ptrs, inputs):
        self.graph, self.outputs, self.launches = None, None, {}
        self.ptrs, self.inputs = ptrs, inputs


class GraphSet:
    """The graphs of one runner: one pool, one capture stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        self.functions = []
        self._warm = False
        self._pool = torch.cuda.graph_pool_handle() if self.on_cuda else None
        self._stream = (torch.cuda.Stream(self.device) if self.on_cuda
                        else None)

    def capture(self, fn, name, inputs=(), *, own_inputs=False,
                limit=None):
        """A :class:`Captured` form of ``fn``; ``inputs`` names the
        positional arguments that are copied into static inputs (clones of
        the first call's with ``own_inputs``); ``limit`` caps the
        captures."""
        c = Captured(self, fn, name, inputs, own_inputs=own_inputs,
                     limit=limit)
        self.functions.append(c)
        return c

    @property
    def captures(self):
        return sum(f.captures for f in self.functions)

    def no_sync(self):
        """The round's sync guard: ``guards.no_transfer`` on the set's
        device."""
        return no_transfer(self.device)


class Captured:
    """``fn`` captured per argument layout (see the module docstring).
    ``captures`` and ``replays`` count this function's graphs."""

    def __init__(self, owner, fn, name, inputs=(), *, own_inputs=False,
                 limit=None):
        self.owner, self.fn, self.name = owner, fn, name
        self.inputs = tuple(inputs)
        self.own_inputs = own_inputs
        self.limit = limit
        self.captures = 0
        self.replays = 0
        self._graphs = {}

    def _lookup(self, args):
        key = _layout(args)
        ptrs = _ptrs(a for i, a in enumerate(args) if i not in self.inputs)
        return key, ptrs, self._graphs.get(key)

    def would_capture(self, *args):
        """Whether a call on ``args`` would capture (no graph holds their
        layout on their storage)."""
        _, ptrs, g = self._lookup(args)
        return g is None or g.ptrs != ptrs

    def __call__(self, *args):
        key, ptrs, g = self._lookup(args)
        ins = tuple(args[i] for i in self.inputs)
        if g is None or g.ptrs != ptrs:
            if self.limit is not None and self.captures >= self.limit:
                raise RecaptureError(
                    f"{self.name}: a call would capture graph "
                    f"{self.captures + 1}, over the limit of {self.limit}: "
                    "an argument changed its layout or its storage")
            if g is not None:
                del self._graphs[key], g  # freed now, not during a capture
                if self.owner.on_cuda and not any(
                        f._graphs for f in self.owner.functions):
                    # that was the pool's last graph: the caching
                    # allocator refuses to capture into a pool no graph
                    # uses any more, so the set takes a fresh one
                    self.owner._pool = torch.cuda.graph_pool_handle()
            return self._first(key, args, ptrs, ins)
        for dst, src in zip(leaves(g.inputs), leaves(ins)):
            if src is not dst:
                dst.copy_(src)
        if not self.owner.on_cuda:
            return self.fn(*self._static(args, g.inputs))
        return self._replay(g)

    def _static(self, args, inputs):
        args = list(args)
        for i, x in zip(self.inputs, inputs):
            args[i] = x
        return args

    def _replay(self, g):
        g.graph.replay()
        self.replays += 1
        for name, n in g.launches.items():
            kops.KERNELS[name].launches += n
        return g.outputs

    def _first(self, key, args, ptrs, ins):
        if self.own_inputs:
            ins = tree_map(torch.clone, ins)
            args = self._static(args, ins)
        g = _Graph(ptrs, ins)
        self.captures += 1
        if not self.owner.on_cuda:
            self._graphs[key] = g
            return self.fn(*args)
        owner = self.owner
        out = None
        warm = owner._warm
        with allow_sync():
            if not warm:
                cur = torch.cuda.current_stream(owner.device)
                owner._stream.wait_stream(cur)
                with torch.cuda.stream(owner._stream):
                    out = self.fn(*args)
                cur.wait_stream(owner._stream)
                owner._warm = True
            before = kops.launch_counts()
            graph = torch.cuda.CUDAGraph()
            # a graph destroyed while another is being captured (by the
            # cyclic collector, freeing a dead runner) invalidates that
            # capture: collect first, and not during it
            collecting = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                # the outer stream context restores the caller's stream
                # even when a failed capture makes the graph context's
                # exit raise
                with torch.cuda.stream(owner._stream), torch.cuda.graph(
                        graph, pool=owner._pool, stream=owner._stream):
                    g.outputs = self.fn(*args)
            finally:
                if collecting:
                    gc.enable()
                recorded = kops.launch_counts()
                for name, fn in kops.KERNELS.items():
                    fn.launches = before[name]
            g.launches = {n: recorded[n] - before[n] for n in recorded
                          if recorded[n] != before[n]}
            g.graph = graph
        self._graphs[key] = g
        return self._replay(g) if warm else out
