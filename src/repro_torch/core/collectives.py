"""The collectives of the pod path over ``torch.distributed``.

In the reference the pod path is ``shard_map`` over the ``pod`` mesh
axis: each pod runs local code on its ``(1, ...)`` shard and
``jax.lax.psum`` / ``ppermute`` / ``axis_index`` cross the pods
(``repro/core/averaging.py``, ``engine.py``, ``api.py``). The port runs
one process per participant, each holding its ``(1, ...)`` slice of the
stacked trees, and :class:`PodAxis` is that process's view of the axis:
its group, its size K, its own index k and the explicit collectives.
There is no counterpart file in the JAX package.

On a mesh with intra-pod axes (``("pod", "data", "model")``) the group
is the rank's pod group, ``mesh.get_group("pod")``: the ranks at the same
``(data, model)`` coordinate of every pod. A pod's row is then a DTensor
over the pod's other axes, and every collective here acts on the rank's
local shard (:func:`local`): the pods place a leaf alike, so the shards
that meet in a pod group hold the same elements, as in the reference's
``shard_map(in_specs=param_specs)``.

Backends. NCCL takes device tensors directly, and needs one card per
rank (``launch/mesh.init_process_mesh`` refuses two ranks on one
device). Gloo reduces on the host: its CUDA ``all_reduce`` stages
through pinned memory itself, and it has no CUDA ``send``/``recv``. So on
a gloo group every collective here goes through :meth:`PodAxis._staged`:
the tensors are copied into one pinned host buffer (device to host),
ONE gloo collective runs on it, and the result is copied back (host to
device). Packing every leaf into one buffer makes a tree's exchange one
collective, as XLA combines the reference's per-leaf psums. The host
buffer is kept and grown, never shrunk. Only the wire crosses the host:
every value is computed on the device.

These calls synchronise with the host (the device-to-host copy must land
before gloo reads it), so they run in an eager finalize, never inside a
captured graph, and inside ``graphs.allow_sync()`` when called under the
round's sync guard. ``stats`` counts every collective's calls, payload
bytes and seconds (device to host, the wire, host to device) and the
point-to-point legs; the device is synchronised before each staged
collective so that its device-to-host time is the copy's alone.

A ring all-reduce reduces each chunk on one rank and copies the result
to the others, so every rank's sum is equal bit for bit.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch
import torch.distributed as dist

from repro_torch.core.graphs import allow_sync

_ALIGN = 16


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping of sizes, or an
    object whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def local(t):
    """The rank's own shard of a DTensor (its local tensor, which the
    collectives write in place); a plain tensor passes through. A pending
    (``Partial``) placement raises: its shard is not a value."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"a DTensor with pending reductions "
                         f"{t.placements} has no local value; redistribute "
                         "it first")
    return t._local_tensor


def plain(t):
    """A DTensor as its whole value on every rank (``full_tensor``: a
    scalar, a loss); a plain tensor passes through."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _nbytes(t):
    return t.numel() * t.element_size()


def _aligned(n):
    return -(-n // _ALIGN) * _ALIGN


class PodAxis:
    """One rank's view of the ``axis`` dimension of ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``)."""

    def __init__(self, mesh, axis: str = "pod"):
        sizes = axis_sizes(mesh)
        if axis not in sizes:
            raise ValueError(f"mesh has no {axis!r} axis; axes: "
                             f"{sorted(sizes)}")
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.size = sizes[axis]
        self.index = int(mesh.get_local_rank(axis))
        self.backend = str(dist.get_backend(self.group))
        self.stats = defaultdict(float)
        self._host = None

    # --- where this rank sits ----------------------------------------------
    def local(self, row):
        """This rank's entry of a whole ``(K, ...)`` row (the liveness row):
        a ``(1, ...)`` view; None passes through."""
        if row is None:
            return None
        if row.shape[0] != self.size:
            raise ValueError(f"expected a row over the {self.size} pods; "
                             f"got shape {tuple(row.shape)}")
        return row.narrow(0, self.index, 1)

    def first_live(self, live_row):
        """Pod index of the first live rank (0 without a liveness row): the
        rank whose row is the shared model. Reads the row on the host."""
        if live_row is None:
            return 0
        with allow_sync():
            return int(torch.argmax(live_row))

    def _peer(self, j):
        return dist.get_global_rank(self.group, j)

    # --- collectives ---------------------------------------------------------
    def all_reduce_(self, tensors, op="all_reduce"):
        """Sum f32 ``tensors`` over the pods, in place."""
        for t in tensors:
            if t.dtype != torch.float32:
                raise ValueError(f"the pod sum runs in f32; got {t.dtype}")
        self._run(op, tensors, lambda buf: dist.all_reduce(
            buf.view(torch.float32), group=self.group))

    def broadcast_(self, tensors, src: int, op="broadcast"):
        """Overwrite ``tensors`` with pod ``src``'s, in place."""
        self._run(op, tensors, lambda buf: dist.broadcast(
            buf, self._peer(src), group=self.group))

    def permute(self, tensors, perm, op="permute"):
        """One point-to-point exchange: this rank sends ``tensors`` to the
        pod it maps to in ``perm`` (``(src, dst)`` pairs over the pod
        indices, a whole permutation) and returns what it receives, new
        tensors shaped like ``tensors``."""
        dst = [d for s, d in perm if s == self.index]
        src = [s for s, d in perm if d == self.index]
        if len(dst) != 1 or len(src) != 1:
            raise ValueError(f"pod {self.index} must send and receive once "
                             f"in {perm}")
        recv = [torch.empty_like(t) for t in tensors]
        self.stats["p2p_legs"] += 1

        def exchange(send_buf, recv_buf):
            ops = [dist.P2POp(dist.isend, send_buf, self._peer(dst[0]),
                              group=self.group),
                   dist.P2POp(dist.irecv, recv_buf, self._peer(src[0]),
                              group=self.group)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        self._run(op, tensors, exchange, out=recv)
        return recv

    def gather_columns(self, x):
        """``(C, 1)`` local values -> the ``(C, K)`` whole, every rank's in
        its column (an all-reduce of a zero-filled buffer: gloo has no CUDA
        all-gather)."""
        x = plain(x)
        full = torch.zeros((x.shape[0], self.size), dtype=torch.float32,
                           device=x.device)
        full[:, self.index:self.index + 1].copy_(x)
        self.all_reduce_([full], op="gather")
        return full

    def all_reduce_scalar(self, x):
        out = plain(x).reshape(1).float().clone()
        self.all_reduce_([out], op="scalar")
        return out[0]

    # --- the one staging helper ----------------------------------------------
    def _run(self, op, tensors, collective, out=None):
        tensors = [local(t) for t in tensors]
        out = None if out is None else [local(t) for t in out]
        st = self.stats
        st[f"{op}_calls"] += 1
        st[f"{op}_bytes"] += sum(_nbytes(t) for t in tensors)
        if self.backend in ("nccl", "fake"):
            t0 = time.perf_counter()
            with allow_sync():
                if out is None:
                    for t in tensors:
                        collective(t)
                else:
                    for s, r in zip(tensors, out):
                        collective(s, r)
                if tensors and tensors[0].is_cuda:
                    torch.cuda.synchronize(tensors[0].device)
            st[f"{op}_wire_s"] += time.perf_counter() - t0
            return
        self._staged(op, tensors, collective, out)

    def _host_bytes(self, n, pinned):
        if (self._host is None or self._host.numel() < n
                or self._host.is_pinned() != pinned):
            self._host = None
            self._host = torch.empty(max(n, 1), dtype=torch.uint8,
                                     pin_memory=pinned)
        return self._host

    @staticmethod
    def _views(region, tensors):
        views, off = [], 0
        for t in tensors:
            n = _nbytes(t)
            views.append(region[off:off + n].view(t.dtype).view(t.shape))
            off += _aligned(n)
        return views

    def _staged(self, op, tensors, collective, out):
        """Gloo: device -> one host buffer -> one collective -> device."""
        st = self.stats
        cuda = any(t.is_cuda for t in tensors)
        size = sum(_aligned(_nbytes(t)) for t in tensors)
        with allow_sync():
            if cuda:
                torch.cuda.synchronize(tensors[0].device)
            t0 = time.perf_counter()
            host = self._host_bytes(size * (1 if out is None else 2), cuda)
            send = host[:size]
            for v, t in zip(self._views(send, tensors), tensors):
                v.copy_(t.detach(), non_blocking=cuda)
            if cuda:
                torch.cuda.synchronize(tensors[0].device)
            t1 = time.perf_counter()
            if out is None:
                collective(send)
                back, dsts = send, tensors
            else:
                back = host[size:2 * size]
                collective(send, back)
                dsts = out
            t2 = time.perf_counter()
            for d, v in zip(dsts, self._views(back, dsts)):
                d.copy_(v, non_blocking=cuda)
            if cuda:
                torch.cuda.synchronize(dsts[0].device)
            t3 = time.perf_counter()
        st[f"{op}_d2h_s"] += t1 - t0
        st[f"{op}_wire_s"] += t2 - t1
        st[f"{op}_h2d_s"] += t3 - t2

    def reset_stats(self):
        self.stats.clear()


# ---------------------------------------------------------------------------
# The staged backend: DTensor's collectives on device tensors over gloo
# ---------------------------------------------------------------------------
STAGED = "staged"


def _host(t):
    """A host copy of ``t`` (pinned for a card's tensor)."""
    if t.device.type == "cpu":
        return t.detach().clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t.detach())
    return h


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class StagedGroup(dist.ProcessGroup):
    """A process group backend of the port's own, for ranks that share a
    card: every collective copies its tensors to the host, runs ONE gloo
    collective there and copies the results back, as
    :meth:`PodAxis._staged` does for the pod path. DTensor calls the
    functional collectives (``_c10d_functional.*``), and gloo's own CUDA
    path crashes the process on them (a segfault in ``wait_tensor`` of an
    all-gather, torch 2.11 on an H100), while its host path is sound. The
    caller names it: ``init_process_mesh(..., backend="staged")`` joins
    ``"cpu:gloo,cuda:staged"``. Every call synchronises with the host, so
    a step over it runs eagerly (no CUDA graph)."""

    def __init__(self, store, rank, size, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(dist.PrefixStore("staged/", store),
                                           rank, size, timeout)
        self._name = None

    def getBackendName(self):
        return STAGED

    # c10d names a Python process group through these (it stands for the
    # whole group, every device type)
    def _set_group_name(self, name):
        self._name = name

    @property
    def group_name(self):
        return self._name

    def _run(self, outputs, inputs, call):
        """``call(host outputs, host inputs)`` runs the gloo collective on
        host copies; the outputs are copied back in place."""
        h_out = [_host(t) for t in outputs]
        h_in = [_host(t) for t in inputs]
        call(h_out, h_in).wait()
        for t, h in zip(outputs, h_out):
            t.copy_(h)
        return _done(outputs)

    def allreduce(self, tensors, opts=None):
        return self._run(tensors, [], lambda o, _: self._gloo.allreduce(
            o, opts or dist.AllreduceOptions()))

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def broadcast(self, tensors, opts=None):
        return self._run(tensors, [], lambda o, _: self._gloo.broadcast(
            o, opts or dist.BroadcastOptions()))

    def barrier(self, opts=None):
        return self.allreduce([torch.zeros(1)])

    def allgather(self, outputs, inputs, opts=None):
        flat = [t for ts in outputs for t in ts]
        n = len(outputs[0])

        def call(o, i):
            return self._gloo.allgather([o[k * n:(k + 1) * n]
                                         for k in range(len(outputs))],
                                        i, opts or dist.AllgatherOptions())
        return self._run(flat, inputs, call)

    def _allgather_base(self, output, input, opts=None):
        return self._run([output], [input], lambda o, i: self._gloo
                         ._allgather_base(o[0], i[0],
                                          opts or dist.AllgatherOptions()))

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def reduce_scatter(self, outputs, inputs, opts=None):
        flat = [t for ts in inputs for t in ts]
        n = len(inputs[0])

        def call(o, i):
            return self._gloo.reduce_scatter(
                o, [i[k * n:(k + 1) * n] for k in range(len(inputs))],
                opts or dist.ReduceScatterOptions())
        return self._run(outputs, flat, call)

    def _reduce_scatter_base(self, output, input, opts=None):
        return self._run([output], [input], lambda o, i: self._gloo
                         ._reduce_scatter_base(
                             o[0], i[0], opts or dist.ReduceScatterOptions()))

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        return self._run([output], [input], lambda o, i: self._gloo
                         .alltoall_base(o[0], i[0], output_split_sizes,
                                        input_split_sizes,
                                        opts or dist.AllToAllOptions()))

    all_to_all_single = alltoall_base

    def send(self, tensors, dst, tag=0):
        h = [_host(t) for t in tensors]
        self._gloo.send(h, dst, tag).wait()
        return _done(tensors)

    def recv(self, tensors, src, tag=0):
        return self._run(tensors, [], lambda o, _: self._gloo.recv(o, src,
                                                                   tag))


def register_staged():
    """Register :class:`StagedGroup` as the ``"staged"`` backend (once)."""
    if STAGED not in dist.Backend.backend_list:
        dist.Backend.register_backend(
            STAGED, lambda store, rank, size, timeout: StagedGroup(
                store, rank, size, timeout), devices=["cpu", "cuda"])
