"""In-model sharding hints that are safe without a mesh, ported from
``repro/sharding/constrain.py``.

``constrain(x, spec)`` pins the placement of a DTensor where the
reference applies ``with_sharding_constraint``: a plain tensor passes
through unchanged (the reference's no-mesh case, which every CPU and
single-card path takes). Any named axis absent from the tensor's mesh, or
that does not divide the dim, is dropped, so model code stays
mesh-agnostic (phi4's 24 heads on a model=16 axis fall back to
unconstrained).

Markers, one per tensor dim:
  None  -> unconstrained (the current placement stays)
  "r"   -> replicated
  "dp"  -> the data-parallel axes, default ("pod", "data"); the
           co-learning participant step narrows this to ("data",) via
           ``batch_axes``, because its rows already carry the pod axis
  name / tuple of names -> those mesh axes, major to minor

A DTensor is redistributed only on the mesh dims the resolved spec
names, and on those that shard a pinned dim otherwise; the other mesh
dims keep their placement (a pending ``Partial`` sum too, unless every
dim is pinned, when it is reduced).

Where DTensor has no sharding rule for an op of the model (the MoE's
sort-based dispatch, the recurrent cells' loops, an in-place state
update on another placement), the model runs that function on local
shards with :func:`local_call`: each input is laid out by its spec (the
same markers, ``None`` replicated), the function runs on the local
tensors, and its outputs are wrapped back by theirs. On plain tensors it
is a plain call.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

_CTX = threading.local()


class _Sizes:
    """An object whose ``shape`` is ``{axis: size}``, as the reference's
    mesh (``_resolve`` reads only that)."""

    def __init__(self, mesh):
        self.shape = {n: int(mesh.size(i))
                      for i, n in enumerate(mesh.mesh_dim_names)}


def _dp_axes():
    return getattr(_CTX, "dp", ("pod", "data"))


@contextlib.contextmanager
def batch_axes(axes):
    """Override the axes "dp" resolves to."""
    prev = _dp_axes()
    _CTX.dp = tuple(axes)
    try:
        yield
    finally:
        _CTX.dp = prev


# the reference's P.UNCONSTRAINED
U = "unconstrained"


def _resolve(dim, ax, mesh, axes):
    """``(entry, pinned)``: the reference's rule for one dim. ``mesh`` has
    ``.shape`` (``{axis: size}``), ``axes`` its axis names."""
    if ax == "r":
        return None, True
    if ax == "dp":
        ax = _dp_axes()
    if isinstance(ax, str):
        ax = (ax,)
    present = tuple(a for a in ax if a in axes)
    # drop leading axes until the product divides the dim
    while present:
        prod = 1
        for a in present:
            prod *= mesh.shape[a]
        if dim % prod == 0 and prod > 1:
            return (present if len(present) > 1 else present[0]), True
        present = present[1:]
    return U, False


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _target(x, spec):
    """The placements ``constrain`` moves DTensor ``x`` to, or None when
    nothing is pinned."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = _Sizes(mesh)
    entries, pinned = [], False
    for dim, ax in zip(x.shape, spec):
        if ax is None:
            entries.append(U)
            continue
        r, ch = _resolve(dim, ax, sizes, set(names))
        entries.append(r)
        pinned |= ch
    entries += [U] * (x.ndim - len(entries))
    if not pinned:
        return None
    free = any(e is U for e in entries)
    out = list(x.placements)
    named = set()
    for d, e in enumerate(entries):
        if e is U or e is None:
            continue
        for a in (e,) if isinstance(e, str) else e:
            named.add(names.index(a))
            out[names.index(a)] = Shard(d)
    for i, p in enumerate(x.placements):
        if i in named:
            continue
        if p.is_shard() and entries[p.dim] is not U:
            out[i] = Replicate()
        elif p.is_partial() and not free:
            out[i] = Replicate()
    return tuple(out)


def constrain(x, spec):
    """``x`` laid out as ``spec`` says (a DTensor), or ``x`` itself."""
    if not _is_dtensor(x):
        return x
    target = _target(x, spec)
    if target is None or tuple(target) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def axis_size(x, axis):
    """The size of mesh axis ``axis`` under DTensor ``x`` (1 when the
    mesh lacks it or ``x`` is a plain tensor)."""
    if not _is_dtensor(x):
        return 1
    names = tuple(x.device_mesh.mesh_dim_names)
    return int(x.device_mesh.size(names.index(axis))) if axis in names else 1


def dp_size(x):
    """How many shards the batch axes ("dp") cut a DTensor's rows into (1
    for a plain tensor)."""
    return math.prod(axis_size(x, a) for a in _dp_axes())


def on_mesh(*trees):
    """Whether any leaf of ``trees`` is a DTensor."""
    from repro_torch.tree import leaves
    return any(_is_dtensor(t) for tree in trees for t in leaves(tree))


def mesh_scope(*trees):
    """The context a step runs in: with a DTensor among ``trees``,
    DTensor's ``implicit_replication`` (the model's own constants, a
    position ``arange``, a zero state, a scalar rate, are replicated
    operands beside DTensors); otherwise nothing."""
    if not on_mesh(*trees):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def index_copy_(dst, dim, index, src):
    """``dst.index_copy_(dim, index, src)``, the decode caches' slot
    write. On a DTensor the write runs on the local shard: ``src`` is laid
    out as ``dst`` (it differs only in the written dim). Where ``dst``'s
    ``dim`` is sharded (a latent cache's sequence over ``model``) DTensor's
    own in-place rule loses the shard's shape, so the write runs on the
    dim made whole and the result goes back in ``dst``'s placement."""
    if not _is_dtensor(dst):
        return dst.index_copy_(dim, index, src)
    from torch.distributed.tensor import Replicate
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    whole = tuple(Replicate() if p.is_shard(dim) else p for p in pl)
    target = dst if whole == pl else dst.redistribute(mesh, whole)
    if _is_dtensor(src):
        src = src.redistribute(mesh, whole).to_local()
    target.to_local().index_copy_(dim, index, src)
    if target is not dst:
        dst.to_local().copy_(target.redistribute(mesh, pl).to_local())
    return dst


def _placements_of(shape, spec, mesh, resolved):
    """Placements for ``local_call``: markers resolve once per call (the
    first input that carries one fixes its axes), ``None`` replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if ax not in resolved:
            if shape is None:
                raise ValueError(f"output marker {ax!r} names no input dim")
            resolved[ax] = _resolve(shape[d], ax, _Sizes(mesh),
                                    set(names))[0]
        e = resolved[ax]
        if e is U or e is None:
            continue
        for a in (e,) if isinstance(e, str) else e:
            out[names.index(a)] = Shard(d)
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor
    wraps a local gradient as it comes, and a later DTensor view of a
    permuted local tensor fails (a scan's input gradients are
    time-major)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local(t, split):
    """``t``'s local tensor. Its gradient comes back pending a sum
    (``Partial``) on the mesh dims in ``split`` where ``t`` is replicated:
    there the call's work is divided (another input is sharded), so each
    rank's gradient is its share."""
    from torch.distributed.tensor import Partial
    grad = [Partial() if i in split and not p.is_shard() else p
            for i, p in enumerate(t.placements)]
    x = t.to_local(grad_placements=grad)
    return _ContiguousGrad.apply(x) if x.requires_grad else x


def local_call(fn, args, in_specs, out_specs, inplace=(), partial=False):
    """``fn(*args)`` on local shards. Each DTensor in ``args`` is laid out
    by its spec in ``in_specs`` (markers as :func:`constrain`'s, ``None``
    replicated; every mesh dim a spec does not name is replicated) and
    ``fn`` gets the local tensors; each output is wrapped back as a
    DTensor by its spec in ``out_specs`` (a tuple, one per output, or one
    spec for a single output). A dict argument or output takes a dict of
    specs, and ``False`` leaves an output as it is. A marker resolves once
    per call, at the first input dim that carries it, so ``"model"``
    shards the same logical dim in and out. ``inplace``: positions of
    ``args`` that ``fn`` writes into; a DTensor among them that had to
    move is written back in its own placement. ``partial``: the outputs
    are each rank's share of a sum over the mesh dims the call splits and
    they do not (a product contracting a dim sharded over ``model``), and
    come back pending that sum (``Partial``). Without a DTensor argument
    it is ``fn(*args)``. Differentiable: the redistributions and the
    wrapping are DTensor's autograd functions, and an input replicated on
    a mesh dim that another input splits gets its gradient as a pending
    sum there (a weight beside batch-sharded rows)."""
    from torch.distributed.tensor import DTensor
    flat = [a for x in args for a in (x.values() if isinstance(x, dict)
                                      else (x,))]
    mesh = next((a.device_mesh for a in flat if _is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    resolved, moved = {}, []

    def place(a, spec, write_back):
        if isinstance(a, dict):
            return {k: place(a[k], spec[k], write_back) for k in a}
        if not _is_dtensor(a):
            return a
        pl = _placements_of(a.shape, spec, mesh, resolved)
        if tuple(pl) == tuple(a.placements):
            return a
        b = a.redistribute(mesh, pl)
        if write_back:
            moved.append((a, b))
        return b
    placed = [place(a, spec, i in inplace)
              for i, (a, spec) in enumerate(zip(args, in_specs))]
    split = {i for a in placed
             for b in (a.values() if isinstance(a, dict) else (a,))
             if _is_dtensor(b)
             for i, p in enumerate(b.placements) if p.is_shard()}

    def unwrap(a):
        if isinstance(a, dict):
            return {k: unwrap(v) for k, v in a.items()}
        return _local(a, split) if _is_dtensor(a) else a
    local_args = [unwrap(a) for a in placed]
    outs = fn(*local_args)
    for a, b in moved:
        a.to_local().copy_(b.redistribute(mesh, a.placements).to_local())

    def wrap(o, s):
        if s is False:
            return o
        if isinstance(o, dict):
            return {k: wrap(o[k], s[k]) for k in o}
        if not hasattr(o, "shape"):
            return o
        pl = _placements_of(None, s, mesh, resolved)
        if partial:
            from torch.distributed.tensor import Partial
            pl = tuple(Partial() if i in split and not p.is_shard() else p
                       for i, p in enumerate(pl))
        return DTensor.from_local(o, mesh, pl, run_check=False)
    if isinstance(outs, tuple):
        return tuple(wrap(o, s) for o, s in zip(outs, out_specs))
    return wrap(outs, out_specs)
