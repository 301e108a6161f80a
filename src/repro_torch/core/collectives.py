"""The collectives of the pod path over ``torch.distributed``.

In the reference the pod path is ``shard_map`` over the ``pod`` mesh
axis: each pod runs local code on its ``(1, ...)`` shard and
``jax.lax.psum`` / ``ppermute`` / ``axis_index`` cross the pods
(``repro/core/averaging.py``, ``engine.py``, ``api.py``). The port runs
one process per participant, each holding its ``(1, ...)`` slice of the
stacked trees, and :class:`PodAxis` is that process's view of the axis:
its group, its size K, its own index k and the explicit collectives.
There is no counterpart file in the JAX package.

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


def check_pod_only(sizes: dict, axis: str = "pod"):
    """Refuse an intra-pod axis (any axis but ``axis``) of size > 1: this
    slice runs one participant per rank and no tensor or data parallelism
    inside a pod."""
    wide = {n: s for n, s in sizes.items() if n != axis and s > 1}
    if wide:
        raise NotImplementedError(
            f"intra-pod mesh axes {wide} (tensor / data parallelism inside "
            "a pod: DTensor placements from sharding/specs.py) not yet "
            "ported, see ROADMAP.md")


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
        check_pod_only(sizes, axis)
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
        full = torch.zeros((x.shape[0], self.size), dtype=torch.float32,
                           device=x.device)
        full[:, self.index:self.index + 1].copy_(x)
        self.all_reduce_([full], op="gather")
        return full

    def all_reduce_scalar(self, x):
        out = x.reshape(1).float().clone()
        self.all_reduce_([out], op="scalar")
        return out[0]

    # --- the one staging helper ----------------------------------------------
    def _run(self, op, tensors, collective, out=None):
        st = self.stats
        st[f"{op}_calls"] += 1
        st[f"{op}_bytes"] += sum(_nbytes(t) for t in tensors)
        if self.backend == "nccl":
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
