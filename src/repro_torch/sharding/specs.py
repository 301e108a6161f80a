"""Partition specs for params, batches and decode caches, and their
DTensor placements, ported from ``repro/sharding/specs.py``.

The same templates and rules as the reference, as pure functions: a spec
is a plain tuple with one entry per dim, an axis name, a tuple of axis
names, or ``None`` for replicated (the reference's ``PartitionSpec``
entries, in order). ``mesh`` is a ``DeviceMesh``, a mapping ``{axis:
size}`` or anything whose ``shape`` is one. Templates are keyed by leaf
name and aligned to the TRAILING dims of the leaf; a template axis whose
dim the mesh axis does not divide is dropped (replicated); co-learning
stacks a leading participant dim over ``pod``.

Spec trees have the params' structure with tuples as leaves, so walk them
with the params (:func:`map_with_specs`). :func:`placements` turns one
spec into the DTensor placements of a ``DeviceMesh`` (one ``Shard(d)`` or
``Replicate()`` per mesh dim; a tuple entry shards one tensor dim over
several mesh dims, major to minor, which DTensor's left-to-right order of
two ``Shard(d)`` on one dim gives when the tuple lists them in the mesh's
order); :func:`distribute` lays a tree of full tensors out as DTensors
(the reference's ``named`` plus ``device_put``) and :func:`gather` brings
them back whole. On a mesh with pods a rank's trees live inside its pod
(:func:`distribute`: the pod's block of every dim the spec puts on
``pod``, the rest on :func:`pod_submesh`); the pods meet only in
``core/collectives.PodAxis``.
``sharding/compat.py`` (a jax version shim) has no counterpart.
"""
from __future__ import annotations

from repro_torch.core.collectives import axis_sizes
from repro_torch.tree import leaves_with_path, tree_map, unflatten_like

# trailing-dim templates per leaf name
_TEMPLATES = {
    # embeddings / head
    "table": ("model", "data"),                 # (V, D)
    # generic dense (head.w is (D,V))
    "w": ("data", "model"),
    "b": ("model",),
    # attention
    "wq": ("data", "model", None),              # (D,H,hd)
    "wk": ("data", "model", None),              # (D,KV,hd)
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),              # (H,hd,D)
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    # FFN
    "wi": ("data", "model"),                    # (D,F) — and (E,D,F) via moe
    "wg": ("data", "model"),
    # MLA
    "w_dq": ("data", "model"),                  # (D,ql)
    "w_uq": (None, "model", None),              # (ql,H,e)
    "w_dkv": ("data", "model"),                 # (D,kl)
    "w_kr": ("data", None),                     # (D,rope)
    "w_uk": (None, "model", None),              # (kl,H,nope)
    "w_uv": (None, "model", None),              # (kl,H,vh)
    "w_o": ("model", None, "data"),             # (H,vh,D)
    # MoE
    "router": ("data", None),                   # (D,E)
    # Mamba
    "in_proj": ("data", "model"),               # (D,2di)
    "conv_w": (None, "model"),                  # (K,di)
    "conv_b": ("model",),
    "x_proj": ("model", None),                  # (di,dtr+2st)
    "A_log": ("model", None),                   # (di,st)
    "D": ("model",),
    "out_proj": ("model", "data"),              # (di,D)
    # xLSTM
    "up": ("data", "model"),                    # (D,2di)
    "down": ("model", "data"),                  # (di,D)
    "w_if": ("model", None, None),              # (di,H,2)
    "b_if": (None, None),
    "gn_g": (None, None),
    "w_in": ("data", None, "model"),            # (D,H,4hd)
    "r": (None, None, "model"),                 # (H,hd,4hd)
    "up1": ("data", "model"),
    "up2": ("data", "model"),
}
# MoE expert weights: leading E dim gets 'model', rest from dense template
_MOE_LEAF = {"wi": ("model", "data", None), "wg": ("model", "data", None),
             "wo": ("model", None, "data")}


def _fits(dim, axis, sizes):
    return axis is not None and axis in sizes and dim % sizes[axis] == 0


def leaf_spec(path_names, shape, mesh, participant=False):
    sizes = axis_sizes(mesh)
    name = path_names[-1]
    in_moe = any(n in ("ffn", "moe") for n in path_names) and \
        name in _MOE_LEAF and len(shape) >= 3 and "shared" not in path_names
    tmpl = _MOE_LEAF[name] if in_moe else _TEMPLATES.get(name)
    ndim = len(shape)
    off = 1 if participant else 0               # leading participant dim
    spec = [None] * ndim
    if participant:
        spec[0] = "pod"
    if tmpl is not None:
        lead = ndim - len(tmpl)                  # stack/repeat dims replicated
        if lead >= off:
            used = {"pod"} if participant else set()
            for i, ax in enumerate(tmpl):
                dim_i = lead + i
                if ax in used:
                    continue
                if _fits(shape[dim_i], ax, sizes):
                    spec[dim_i] = ax
                    used.add(ax)
    return tuple(spec)


def _shape(v):
    return tuple(v.shape)


def param_specs(params_shapes, cfg, mesh, participant=False):
    """Tree of tensors (or anything with ``.shape``) -> tree of specs."""
    flat = leaves_with_path(params_shapes)
    return unflatten_like(params_shapes, [
        leaf_spec(path.split("/"), _shape(v), mesh, participant)
        for path, v in flat])


def _dp_axes(sizes, participant):
    """Data-parallel axes for the batch dim."""
    if participant:
        return "data"                            # leading K dim carries 'pod'
    return tuple(a for a in ("pod", "data") if a in sizes) or None


def batch_specs(cfg, mesh, kind="train", participant=False):
    """Specs for the input batch dict (tokens/labels/prefix or decode)."""
    dp = _dp_axes(axis_sizes(mesh), participant)
    lead = ("pod",) if participant else ()
    tok = (*lead, dp, None)
    out = {"tokens": tok, "labels": tok}
    if cfg.input_mode == "tokens+prefix":
        out["prefix"] = (*lead, dp, None, None)
    if kind == "decode":
        out = {"tokens": (*lead, dp, None)}
    return out


def cache_specs(cache_shapes, mesh, batch_size, participant=False):
    """Decode-cache specs: batch over data (when divisible), long dims over
    model; falls back for batch=1 (long_500k) by sharding the sequence /
    state dims over both axes where divisible."""
    sizes = axis_sizes(mesh)
    dsz = sizes.get("data", 1)
    msz = sizes.get("model", 1)
    lead = ("pod",) if participant else ()
    dp = tuple(a for a in ("pod", "data") if a in sizes) \
        if not participant else ("data",)

    def one(names, shape):
        off = len(lead)
        # layout: (repeats, B, ...) — repeats replicated
        spec = [None] * len(shape)
        for i, _ in enumerate(lead):
            spec[i] = lead[i]
        bdim = off + 1                           # after repeats dim
        rest = list(range(bdim + 1, len(shape)))
        b_ok = shape[bdim] % dsz == 0 and shape[bdim] > 1
        if b_ok:
            spec[bdim] = dp if len(dp) > 1 else dp[0]
        if names[-1] in ("k", "v") and len(shape) - off == 5:
            # GQA KV cache (R,B,S,KV,hd): never shard S over `model` (the
            # per-step single-slot update would move the whole cache).
            # Shard KV heads if divisible, else head_dim; batch=1
            # long-context spreads S over `data`.
            kv_dim, hd_dim = off + 3, off + 4
            if shape[kv_dim] % msz == 0:
                spec[kv_dim] = "model"
            elif shape[hd_dim] % msz == 0:
                spec[hd_dim] = "model"
            if not b_ok and shape[off + 2] % dsz == 0:
                spec[off + 2] = "data"
            return tuple(spec)
        if b_ok:
            # shard the largest remaining dim over model
            cands = [i for i in rest if shape[i] % msz == 0 and shape[i] >= msz]
            if cands:
                big = max(cands, key=lambda i: shape[i])
                spec[big] = "model"
        else:
            # batch=1: spread the biggest dims over model then data
            cands = sorted(rest, key=lambda i: -shape[i])
            used = []
            for ax, sz in (("model", msz), ("data", dsz)):
                for i in cands:
                    if i not in used and shape[i] % sz == 0 and shape[i] >= sz:
                        spec[i] = ax
                        used.append(i)
                        break
        return tuple(spec)

    return unflatten_like(cache_shapes, [
        one(path.split("/"), _shape(v))
        for path, v in leaves_with_path(cache_shapes)])


def _is_spec(x):
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_with_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree and its spec tree (whose leaves are
    spec tuples); containers are rebuilt as in ``tree_map``."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], spec_tree[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_specs(fn, t, s)
                          for t, s in zip(tree, spec_tree))
    if tree is None:
        return None
    if not _is_spec(spec_tree):
        raise ValueError(f"expected a spec tuple for a leaf of shape "
                         f"{tuple(tree.shape)}; got {spec_tree!r}")
    return fn(tree, spec_tree)


def placements(spec, mesh):
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    one per mesh dim, ``Shard(d)`` where the spec puts tensor dim ``d`` on
    that axis, else ``Replicate()``. A tuple entry must list its axes in
    the mesh's order (major to minor): DTensor applies two ``Shard(d)`` of
    one dim left to right. An axis the mesh lacks, or named twice, raises
    ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            if a in used:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            used.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {axes} is not in the mesh's axis order {names}: "
                "DTensor shards one dim over several mesh dims major to "
                "minor in mesh order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, spec_tree, mesh, axis="pod"):
    """A tree of full tensors (the same values on every rank) as DTensors
    placed by ``spec_tree``. Each rank keeps its own chunks of its copy:
    nothing crosses the wire.

    On a mesh with an ``axis`` dim (the pods) every tree is placed inside
    the rank's pod: a dim whose spec names ``axis`` (alone, or first of a
    tuple: the pods are the major part) keeps this pod's block, and the
    rest is placed on :func:`pod_submesh` by the spec without ``axis``. So
    a stacked ``(K, ...)`` participant tree gives the pod's ``(1, ...)``
    row, and a batch over ``("pod", "data")`` the pod's rows, split over
    ``data``. A DTensor never spans pods: what crosses them goes through
    ``core/collectives.PodAxis`` (Eq. 2, a step's gradient mean), and
    DTensor's rule search stays on two mesh dims (on three it takes
    minutes an op). On a pod-only mesh the rows stay plain tensors."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    names = tuple(mesh.mesh_dim_names)
    sub = mesh
    if axis in names:
        sub = pod_submesh(mesh, axis)
        K = int(mesh.size(names.index(axis)))
        p = int(mesh.get_local_rank(axis))

    def one(t, spec):
        if axis in names:
            for d, e in enumerate(spec):
                axes = (e,) if isinstance(e, str) else tuple(e or ())
                if axis not in axes:
                    continue
                if axes[0] != axis:
                    raise ValueError(f"spec entry {e} puts {axis!r} inside "
                                     "another axis; it must be the major "
                                     "part")
                n = t.shape[d] // K
                t = t.narrow(d, p * n, n)
            spec = row_specs(spec, axis)
        if sub is None:
            return t.clone()
        pl = placements(spec, sub)
        dt = distribute_tensor(t, sub, pl, src_data_rank=None)
        mine = dt.to_local()
        if mine.untyped_storage().data_ptr() != \
                t.untyped_storage().data_ptr():
            return dt
        # a replicated (or leading-dim) chunk is a view of the caller's
        # tensor: the steps write their params in place
        return DTensor.from_local(mine.clone(), sub, pl, run_check=False)
    return map_with_specs(one, tree, spec_tree)


def gather(tree):
    """DTensor leaves made whole inside their mesh (``full_tensor``, an
    all-gather; a pod's rows on a mesh with pods); plain tensors pass
    through."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def pod_submesh(mesh, axis="pod"):
    """The mesh of ``mesh``'s axes other than ``axis``: one pod's ranks,
    where a pod's DTensors live (None for a pod-only mesh)."""
    names = tuple(n for n in mesh.mesh_dim_names if n != axis)
    if not names:
        return None
    return mesh[names if len(names) > 1 else names[0]]


def row_specs(spec_tree, axis="pod"):
    """``spec_tree`` with ``axis`` taken out of every entry."""
    def one(spec):
        out = []
        for e in spec:
            if isinstance(e, tuple):
                e = tuple(a for a in e if a != axis) or None
                e = e[0] if e is not None and len(e) == 1 else e
            elif e == axis:
                e = None
            out.append(e)
        return tuple(out)
    if _is_spec(spec_tree):
        return one(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: row_specs(v, axis) for k, v in spec_tree.items()}
    return type(spec_tree)(row_specs(v, axis) for v in spec_tree)
