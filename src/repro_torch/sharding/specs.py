"""Partition specs for params, batches and decode caches, ported from
``repro/sharding/specs.py``.

The same templates and rules as the reference, as pure functions: a spec
is a plain tuple with one entry per dim, an axis name, a tuple of axis
names, or ``None`` for replicated (the reference's ``PartitionSpec``
entries, in order). ``mesh`` is a ``DeviceMesh``, a mapping ``{axis:
size}`` or anything whose ``shape`` is one. Templates are keyed by leaf
name and aligned to the TRAILING dims of the leaf; a template axis whose
dim the mesh axis does not divide is dropped (replicated); co-learning
stacks a leading participant dim over ``pod``.

Spec trees have the params' structure with tuples as leaves, so walk them
with the params (:func:`check_pod_specs` only reads the axis names). This
slice places only the ``pod`` axis: a spec that puts ``data`` or
``model`` on an axis of size > 1 raises ``NotImplementedError`` in
:func:`check_pod_specs`, which every pod aggregate calls (the DTensor
placements are the next slice). ``named`` and ``sharding/compat.py``
have no counterpart.
"""
from __future__ import annotations

from repro_torch.core.collectives import axis_sizes, check_pod_only
from repro_torch.tree import leaves_with_path, unflatten_like

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


def _axis_names(spec_tree, out):
    if isinstance(spec_tree, dict):
        for v in spec_tree.values():
            _axis_names(v, out)
    elif isinstance(spec_tree, (list, tuple)):
        for v in spec_tree:
            _axis_names(v, out)
    elif isinstance(spec_tree, str):
        out.add(spec_tree)
    return out


def check_pod_specs(spec_tree, mesh, axis="pod"):
    """Refuse a spec tree that places an intra-pod axis of size > 1 (the
    pod path runs each rank's ``(1, ...)`` slice whole); returns it."""
    if spec_tree is None:
        return None
    sizes = axis_sizes(mesh)
    check_pod_only({n: sizes.get(n, 1) for n in _axis_names(spec_tree, set())},
                   axis)
    return spec_tree
