"""Multi-pod dry run, ported from ``repro/launch/dryrun.py``: trace every
(arch x input shape x mesh x variant) against the production meshes.

The reference lowers and compiles each combination for 512 forced host
devices and reads XLA's ``cost_analysis`` / ``memory_analysis``. Here ONE
process joins the ``"fake"`` backend as rank 0 of a world of 512
(``launch/mesh.init_process_mesh``), lays the reference's meshes over it
(``make_production_mesh``: (16, 16) ``("data", "model")`` and (2, 16,
16) ``("pod", "data", "model")``), places the params, batches and caches
as the reference's ``build`` does (``sharding/specs.py``; a rank's trees
live inside its pod, ``specs.distribute``) with ``meta`` tensors as every
DTensor's local shard, and runs the step once. Nothing is computed and
nothing is allocated: the fake group's collectives move nothing.

Costs are per device, of the LOCAL ops, read by a dispatch mode
(:class:`CostMode`) that sees the ops DTensor runs on rank 0's shards
and skips the DTensor-level ops (whose shapes are global; a FLOP counter
around the DTensor program counts the whole mesh's work):

* ``flops``: 2·m·n·k for the products (``torch.utils.flop_counter``'s
  registry), one per output element of a pointwise op, one per input
  element of a reduction;
* ``bytes``: every non-view op's input and output bytes (an eager
  program's, with no fusion: above XLA's post-fusion "bytes accessed");
* ``link_bytes``: each collective's bytes over the reference's ring model
  (``link_bytes``: an all-gather moves ``n (g-1)/g`` of its gathered
  ``n`` bytes, a reduce-scatter ``n (g-1)`` of its scattered ``n``, an
  all-reduce ``2 n (g-1)/g``, an all-to-all ``n (g-1)/g``, a permute or
  send ``n``), from the local tensor's bytes and the group's size;
  ``cross_pod_link_bytes`` those of groups that span pods;
* memory: ``argument_bytes`` (the step's local inputs), ``output_bytes``,
  ``alias_bytes`` (outputs that are inputs' storage), the peak of live
  local storage over the step (``peak_bytes_per_device``, arguments
  included) and ``temp_bytes`` (the peak beyond arguments and outputs),
  judged against an H100's 80 GB of HBM3 (``fits_hbm``).

Eager tracing runs every layer. A loop whose trips run the same ops on
the same shapes (the recurrences' steps, ``chunked_scan``'s chunks, the
attention's query and key tiles: ``models/layers.trips``) is traced as
its first trip, one trip booked as many times as the middle ones, and
its last (:class:`CostMode`): on ``meta`` no trip has data, so the books
equal those of every trip run, which a test holds against the eager
trace of every trip. So the raw trace is the full program: ``profile``
(the reference's depth differencing: reduced configs with every segment
at one repeat, then one more per segment, extrapolated to the true
depth) agrees with ``scan_raw_cost``, and
``analytic.scan_correction_flops`` is 0: nothing is missed, where the
reference adds ``analytic.scan_corrections`` because XLA counts a
``lax.scan`` body once. ``compile_s`` keeps its key and holds the trace's
seconds. Every step takes ``impl="ref"`` (a DTensor never reaches a
kernel); the round runs its epochs eagerly (``steps.
make_fused_round_step`` on a mesh with intra-pod axes). The multi-pod
``train_vanilla`` step averages its gradients over the pods
(``steps.make_train_step(mesh=)``), whose all-reduce is its cross-pod
traffic.

Usage:  python -m repro_torch.launch.dryrun [--arch ID|all]
        [--shape NAME|all] [--mesh single|multi|both]
        [--out artifacts/dryrun_torch] [--no-profile]
        [--profile-meshes single]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.launch import analytic
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import init_process_mesh, make_production_mesh
from repro_torch.sharding import specs as sp
from repro_torch.tree import leaves, tree_map

WORLD = 512
_LEAF_SEQ = 2 ** 64 - 1         # an AccumulateGrad node's sequence number
HBM_BYTES = 80e9                              # H100 80GB HBM3
META = torch.device("meta")

VARIANTS = {
    "train": {"single": ["train_vanilla"],
              "multi": ["train_vanilla", "train_colearn", "average",
                        "round_colearn"]},
    "prefill": {"single": ["prefill"], "multi": ["prefill"]},
    "decode": {"single": ["serve"], "multi": ["serve"]},
}


def link_bytes(op, nbytes, g):
    """The reference's ring model: per-device link bytes of one
    collective whose result holds ``nbytes`` over a group of ``g``."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return nbytes * (g - 1)
    if op == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if op == "all-to-all":
        return nbytes * (g - 1) / g
    return float(nbytes)              # a permute, a send, a broadcast


def _microbatch(shape):
    if shape.kind != "train":
        return 1
    tokens = shape.global_batch * shape.seq_len
    m = max(1, tokens // (32 * 8192))            # ~8k tokens/device/microbatch
    while shape.global_batch % m:
        m -= 1
    return m


def _reduced(cfg, repeats):
    segs = tuple((pat, r) for (pat, _), r in zip(cfg.segments, repeats))
    n = sum(len(p) * r for p, r in segs)
    return cfg.with_(n_layers=n, segments=segs)


# ---------------------------------------------------------------------------
# The per-device account
# ---------------------------------------------------------------------------
def _nbytes(t):
    return t.numel() * t.element_size()


def _flat(x, out):
    """The tensors (and DTensors) among an op's arguments or results,
    lists and dicts opened (a process group is left alone)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _storage_key(t):
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage()).cdata


_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
               "var", "std", "norm", "linalg_vector_norm", "prod", "argmax",
               "argmin", "cumsum", "_log_softmax", "_softmax", "topk",
               "sort", "var_mean"}
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
# functional collectives: (the reference's HLO name, the group-size and
# group-name argument positions)
_FUNCOL = {"all_gather_into_tensor": ("all-gather", 1, 2),
           "reduce_scatter_tensor": ("reduce-scatter", 2, 3),
           "all_reduce": ("all-reduce", None, 2),
           "all_to_all_single": ("all-to-all", None, 3),
           "broadcast": ("collective-permute", None, 2)}
# c10d ops (the pod axis's explicit collectives): the process group's
# argument position
_C10D = {"allreduce_": ("all-reduce", 1), "broadcast_": ("broadcast", 1),
         "allgather_": ("all-gather", 2),
         "allgather_into_tensor_coalesced_": ("all-gather", 2),
         "_allgather_base_": ("all-gather", 2),
         "reduce_scatter_": ("reduce-scatter", 2),
         "_reduce_scatter_base_": ("reduce-scatter", 2),
         "alltoall_base_": ("all-to-all", 2), "send": ("send", 1),
         "recv_": ("send", 1)}


def _propagating():
    """DTensor is propagating a sharding through an op's decomposition
    (the ``meta`` tensors it makes for it have no ``_spec`` yet)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_through_decomp":
            return True
        f = f.f_back
    return False


class CostMode(TorchDispatchMode):
    """Counts the ops that run on plain ``meta`` tensors — a DTensor's
    local shards — and skips every op that has a DTensor argument (it
    returns ``NotImplemented``: DTensor then runs its local ops, which
    come back here), a tensor on another device or a ``meta`` tensor that
    carries a ``_spec`` (DTensor's shape propagation; an op it has no
    rule for it propagates through the op's decomposition on ``meta``
    tensors of the global shape, once per new shape: counting those ran
    the op's whole global work on the device, and only the first time).
    ``pod_ranks`` is the number of ranks of one pod: a group whose ranks
    lie in two pods is cross-pod.

    A loop of alike trips (``models/layers.trips``) runs three of them
    under :meth:`trips`, and everything trip 1 costs is booked ``n - 2``
    times: its ops as they run (a scale over the forward ops inside it),
    and, in the backward pass, the ops of every autograd node made inside
    it (the engine runs a node's backward and the accumulation of what it
    returns with that node current), so the books equal the whole loop's
    exactly. The storage trip 1 leaves live when its loop ends (saved
    activations, outputs, the carries a checkpoint keeps) stands for
    ``n - 2`` copies: the other ``n - 3`` are live beside it from then
    on, and when it dies in a backward node outside trip 1's nodes (trip
    1's output carry, saved by trip n - 1, whose backward runs first)
    they live on until trip 1's nodes have run, as the whole loop's
    middle trips keep theirs until their own backward."""

    def __init__(self, pod_ranks=None):
        super().__init__()
        self.pod_ranks = pod_ranks
        self.flops = 0.0
        self.bytes = 0.0
        self.colls = []
        self.live = 0
        self.peak = 0
        self._refs = {}
        self._scopes = []       # open trip 1s: [factor, storage born there]
        self._born = []         # those sets, and those of closed trip 1s
        self._windows = []      # the peaks of open trips n - 1
        self._nodes = []        # (first, end, factor): autograd nodes made
        self._node_factor = {}  # in a trip 1, by their sequence numbers
        self._copies = {}       # storage -> [(bytes, owner)] of its copies
        self._orphans = []      # [bytes, owner, entered] of dead storage

    # --- repeated trips ------------------------------------------------------
    def trips(self, n):
        """The loop of ``n`` alike trips that ``layers.trips`` hands out
        while this mode is active (``n > 3``)."""
        return _Trips(self, n)

    def _node_scale(self):
        """The factor of the autograd node whose backward runs now (None
        outside the backward pass and for a leaf's accumulation)."""
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        s = node._sequence_nr()
        if s == _LEAF_SEQ:
            return None
        g = self._node_factor.get(s)
        if g is None:
            g = 1
            for first, end, k in self._nodes:
                if first <= s < end:
                    g *= k
            self._node_factor[s] = g
        return g

    def _factor(self):
        """How many times an op that runs now is booked."""
        f = 1
        for scope in self._scopes:
            f *= scope[0]
        if self._nodes:
            f *= self._node_scale() or 1
        return f

    # --- live storage ------------------------------------------------------
    def hold(self, tensors):
        """Count ``tensors`` (the arguments) as live from now on."""
        for t in tensors:
            self._track(t)

    def _outside(self, owner):
        """A backward node outside the nodes whose factor is ``owner``
        runs now (not a recomputation, which runs with grad on)."""
        g = self._node_scale()
        return (g is not None and not torch.is_grad_enabled()
                and g % owner != 0)

    def _release(self, key):
        ref = self._refs[key]
        if ref[0] > 1:
            ref[0] -= 1
            return
        del self._refs[key]
        self.live -= ref[1]
        for born in self._born:
            born.discard(key)
        for nbytes, owner in self._copies.pop(key, ()):
            if self._outside(owner):
                self._orphans.append([nbytes, owner, False])
            else:
                self.live -= nbytes

    def _settle(self):
        """Free the orphaned copies whose owners' nodes have run."""
        g = self._node_scale()
        if g is None or torch.is_grad_enabled():
            return
        keep = []
        for o in self._orphans:
            inside = g % o[1] == 0
            if o[2] and not inside:
                self.live -= o[0]
                continue
            o[2] = o[2] or inside
            keep.append(o)
        self._orphans = keep

    def _peak(self, value):
        self.peak = max(self.peak, value)
        for w in self._windows:
            w[0] = max(w[0], value)

    def _track(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return
        key = _storage_key(t)
        if key in self._refs:
            self._refs[key][0] += 1
        else:
            size = t.untyped_storage().nbytes()
            self._refs[key] = [1, size]
            self.live += size
            self._peak(self.live)
            if self._scopes:
                self._scopes[-1][1].add(key)
        weakref.finalize(t, self._release, key)

    def _repeat(self, keys, f, window, owner):
        """Storage ``keys`` born in a trip 1 and live at its loop's end
        stand for ``f`` trips' copies from now on (``owner``: the factor
        of that trip 1's nodes), and the peak of trip n - 1 (``window``)
        had the other ``f - 1`` beside it."""
        extra = 0
        for k in keys:
            copies = self._copies.setdefault(k, [])
            nbytes = (f - 1) * (self._refs[k][1] + sum(b for b, _ in copies))
            copies.append((nbytes, owner))
            extra += nbytes
        self.live += extra
        self._peak(window + extra)
        if self._scopes:
            self._scopes[-1][1].update(keys)

    # --- the ops -------------------------------------------------------------
    def _group(self, pg):
        from torch.distributed import distributed_c10d as c10d
        if isinstance(pg, str):
            pg = c10d._resolve_process_group(pg)
        elif not isinstance(pg, c10d.ProcessGroup):
            pg = c10d.ProcessGroup.unbox(pg)        # a c10d op's boxed group
        ranks = c10d.get_process_group_ranks(pg)
        cross = (self.pod_ranks is not None
                 and len({r // self.pod_ranks for r in ranks}) > 1)
        return len(ranks), cross

    def _collective(self, kind, nbytes, g, cross):
        f = self._factor()
        self.colls.append({"op": kind,
                           "link_bytes": f * link_bytes(kind, nbytes, g),
                           "group": g, "cross_pod": cross, "n": f})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if self._orphans:
            self._settle()
        ins = _flat((args, kwargs), [])
        if any(isinstance(a, DTensor) for a in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _flat(out, [])
        if any(t.device.type != "meta" or hasattr(t, "_spec")
               for t in ins + outs) or (not ins and _propagating()):
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in _FUNCOL:
            kind, g_at, pg_at = _FUNCOL[name]
            g, cross = self._group(args[pg_at])
            res = outs[0] if outs else ins[0]
            self._collective(kind, _nbytes(res), g, cross)
        elif ns == "c10d" and name in _C10D:
            kind, pg_at = _C10D[name]
            g, cross = self._group(args[pg_at])
            self._collective(kind, sum(_nbytes(t) for t in ins), g, cross)
        elif not func.is_view and name not in _ALLOC:
            self._count(func, name, args, kwargs, ins, outs, out)
        for o in outs:
            self._track(o)
        return out

    def _count(self, func, name, args, kwargs, ins, outs, out):
        from torch.utils.flop_counter import flop_registry
        f = self._factor()
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += f * fn(*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += f * sum(o.numel() for o in outs)
        elif name in _REDUCTIONS and ins:
            self.flops += f * ins[0].numel()
        self.bytes += f * sum(_nbytes(t) for t in ins + outs)

    def summary(self):
        by_op = {}
        for c in self.colls:
            by_op[c["op"]] = by_op.get(c["op"], 0.0) + c["link_bytes"]
        return {"flops": self.flops, "bytes": self.bytes,
                "link_bytes": sum(c["link_bytes"] for c in self.colls),
                "cross_pod_link_bytes": sum(c["link_bytes"]
                                            for c in self.colls
                                            if c["cross_pod"]),
                "by_op": by_op, "n_coll": sum(c["n"] for c in self.colls)}


class _Trips:
    """Trips 0, 1 and n - 1 of a loop of ``n`` alike trips, trip 1 booked
    ``n - 2`` times by ``mode`` (:class:`CostMode`); ``pick`` and ``join``
    give the ops ``layers._Loop``'s give on the whole loop."""

    def __init__(self, mode, n):
        self.mode, self.n = mode, n

    def __iter__(self):
        mode, f = self.mode, self.n - 2
        yield 0
        scope = [f, set()]
        mode._born.append(scope[1])
        first = torch._C._autograd._get_sequence_nr()
        mode._scopes.append(scope)
        owner = mode._factor()
        try:
            yield 1
        finally:
            mode._scopes = [x for x in mode._scopes if x is not scope]
            mode._nodes.append((first, torch._C._autograd._get_sequence_nr(),
                                f))
        window = [mode.live]
        mode._windows.append(window)
        try:
            yield self.n - 1
        finally:
            mode._windows = [w for w in mode._windows if w is not window]
            mode._born = [b for b in mode._born if b is not scope[1]]
            mode._repeat(scope[1], f, window[0], owner)

    def pick(self, x):
        return _Pick.apply(x, self.n)

    def join(self, parts, dim=0, stack=False):
        return _Join.apply(self.n, dim, stack, *parts)


class _Pick(torch.autograd.Function):
    """Trips 0, 1 and n - 1 of ``x.unbind(0)``. The backward pass stacks
    the n gradients the whole loop's unbind stacks, trip 1's n - 2 times."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x[0], x[1], x[n - 1]

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return torch.stack([g0] + [g1] * (ctx.n - 2) + [g2]), None


class _Join(torch.autograd.Function):
    """The stack (or cat) along ``dim`` of trips 0, 1 and n - 1's parts,
    trip 1's n - 2 times: the whole loop's op on its shapes. The backward
    pass hands each part its slice, as a stack's or cat's does (views)."""

    @staticmethod
    def forward(ctx, n, dim, stack, *parts):
        ctx.n, ctx.dim, ctx.stack = n, dim, stack
        ctx.w = 1 if stack else parts[0].shape[dim]
        whole = [parts[0]] + [parts[1]] * (n - 2) + [parts[2]]
        return (torch.stack if stack else torch.cat)(whole, dim)

    @staticmethod
    def backward(ctx, g):
        n, dim, w = ctx.n, ctx.dim, ctx.w
        if ctx.stack:
            gs = (g.select(dim, 0), g.select(dim, 1), g.select(dim, n - 1))
        else:
            gs = (g.narrow(dim, 0, w), g.narrow(dim, w, w),
                  g.narrow(dim, (n - 1) * w, w))
        return (None, None, None) + gs


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in leaves(tree) if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# The steps, placed as the reference's build places them
# ---------------------------------------------------------------------------
def _meta(shape_, dtype):
    return torch.empty(shape_, dtype=dtype, device=META)


def build(cfg, shape, mesh, multi_pod, variant):
    """-> (run, args): ``run(*args)`` is the step on DTensor arguments."""
    pshapes = steps_mod.params_shapes(cfg)
    K = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("pod", 1)
    participant = (variant in ("train_colearn", "average", "round_colearn")
                   and multi_pod)
    if participant:
        pshapes = tree_map(lambda v: _meta((K, *v.shape), v.dtype), pshapes)
    pspecs = sp.param_specs(pshapes, cfg, mesh, participant=participant)
    params = sp.distribute(pshapes, pspecs, mesh)

    if variant in ("train_vanilla", "train_colearn"):
        data = steps_mod.input_specs(cfg, shape,
                                     participants=K if participant else 0)
        batch = sp.distribute(data, sp.batch_specs(cfg, mesh, "train",
                                                   participant), mesh)
        mb = _microbatch(shape)
        step = (steps_mod.make_colearn_train_step(cfg, microbatch=mb)
                if participant else
                steps_mod.make_train_step(cfg, microbatch=mb, mesh=mesh))
        return step, (params, batch)

    if variant == "average":
        from repro_torch.core.averaging import make_average_shard_map
        return make_average_shard_map(mesh, pspecs), (params,)

    if variant == "round_colearn":
        # the fused round on the pod mesh: T_dry = 2 epochs of one batch
        # (the real T_i only changes the epoch count), Eq. 2 and Eq. 4
        T_dry, n_b = 2, 1
        data = steps_mod.input_specs(cfg, shape, participants=K)
        data = tree_map(lambda v: _meta((T_dry, v.shape[0], n_b,
                                         *v.shape[1:]), v.dtype), data)
        bspecs = sp.batch_specs(cfg, mesh, "train", participant=True)
        rspecs = {k: (None, *s[:1], None, *s[1:]) for k, s in bspecs.items()}
        batches = sp.distribute(data, rspecs, mesh)
        ccfg = CoLearnConfig(n_participants=K, T0=T_dry, max_rounds=1)
        round_fn = steps_mod.make_fused_round_step(cfg, ccfg, mesh=mesh,
                                                   param_specs=pspecs)
        return round_fn, (params, (), batches, 0)

    if variant == "prefill":
        data = steps_mod.input_specs(cfg, shape)
        batch = sp.distribute(data, sp.batch_specs(cfg, mesh, "train"), mesh)
        return steps_mod.make_prefill_step(cfg), (params, batch)

    # serve (decode)
    data = steps_mod.input_specs(cfg, shape)
    cache = sp.distribute(data["cache"], sp.cache_specs(
        data["cache"], mesh, shape.global_batch), mesh)
    # the token rows follow the cache's (a pod holds its rows of both)
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    dsz = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("data", 1)
    B = shape.global_batch
    b_spec = dp if B % dsz == 0 and B > 1 else None
    token = sp.distribute({"t": data["token"]}, {"t": (b_spec, None)},
                          mesh)["t"]
    pos = torch.zeros((), dtype=torch.int32, device=META)
    return steps_mod.make_serve_step(cfg), (params, cache, token, pos)


def _trace(cfg, shape, mesh, multi_pod, variant):
    """Run one step under :class:`CostMode` -> (costs, memory, seconds)."""
    t0 = time.time()
    run, args = build(cfg, shape, mesh, multi_pod, variant)
    pod_ranks = (mesh.mesh.numel() // mesh.mesh.shape[0]
                 if "pod" in mesh.mesh_dim_names else None)
    mode = CostMode(pod_ranks)
    arg_locals = _local_tensors(args)
    mode.hold(arg_locals)
    with mode:
        out = run(*args)
    out_locals = _local_tensors(out)
    arg_keys = {_storage_key(t) for t in arg_locals}
    out_bytes = sum(_nbytes(t) for t in out_locals)
    alias = sum(_nbytes(t) for t in out_locals
                if _storage_key(t) in arg_keys)
    argument = sum(_nbytes(t) for t in arg_locals)
    peak = max(mode.peak, argument + out_bytes - alias)
    memory = {"argument_bytes": argument, "output_bytes": out_bytes,
              "temp_bytes": max(peak - argument - out_bytes + alias, 0),
              "alias_bytes": alias, "peak_bytes_per_device": peak,
              "hbm_bytes": HBM_BYTES, "fits_hbm": peak <= HBM_BYTES}
    return mode.summary(), memory, time.time() - t0


def profile_costs(cfg, shape, mesh, multi_pod, variant):
    """Depth-differenced per-layer costs extrapolated to full depth (the
    reference's; exact here, see the module docstring)."""
    n_seg = len(cfg.segments)
    base_r = [1] * n_seg
    t0 = time.time()
    c_base = _trace(_reduced(cfg, base_r), shape, mesh, multi_pod,
                    variant)[0]
    deltas = []
    for s in range(n_seg):
        r = list(base_r)
        r[s] += 1
        c_s = _trace(_reduced(cfg, r), shape, mesh, multi_pod, variant)[0]
        deltas.append({k: (c_s[k] - c_base[k]) if not isinstance(c_base[k],
                                                                 dict)
                       else {o: c_s[k].get(o, 0) - c_base[k].get(o, 0)
                             for o in set(c_base[k]) | set(c_s[k])}
                       for k in c_base})
    full = {}
    for k in ("flops", "bytes", "link_bytes", "cross_pod_link_bytes"):
        full[k] = c_base[k] + sum(
            max(d[k], 0.0) * (R - 1)
            for d, (_, R) in zip(deltas, cfg.segments))
    full["by_op"] = {
        o: c_base["by_op"].get(o, 0.0) + sum(
            max(d["by_op"].get(o, 0.0), 0.0) * (R - 1)
            for d, (_, R) in zip(deltas, cfg.segments))
        for o in set().union(c_base["by_op"],
                             *[d["by_op"] for d in deltas])}
    full["profile_s"] = round(time.time() - t0, 1)
    full["per_layer"] = deltas
    full["outside"] = c_base
    return full


_MESHES = {}


def _mesh(multi_pod):
    """The production mesh over the fake world (joined once)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        init_process_mesh(0, WORLD, "", "fake")
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                  device="cpu")
    return _MESHES[multi_pod]


def run_one(arch, shape_name, mesh_kind, variant, profile=True):
    multi_pod = mesh_kind == "multi"
    mesh = _mesh(multi_pod)
    shape = INPUT_SHAPES[shape_name]
    cfg = steps_mod.config_for_shape(get_config(arch), shape)
    costs, memory, seconds = _trace(cfg, shape, mesh, multi_pod, variant)
    total_p, active_p = analytic.param_counts(cfg)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "compile_s": round(seconds, 1),
        "n_devices": int(mesh.mesh.numel()),
        "microbatch": _microbatch(shape) if "train" in variant else 1,
        "params_total": int(total_p), "params_active": int(active_p),
        "memory": memory,
        "scan_raw_cost": costs,
        "analytic": {
            "model_flops": analytic.model_flops(cfg, shape, shape.kind)
            if variant not in ("average", "round_colearn") else 0.0,
            "scan_correction_flops": 0.0,
        },
    }
    if profile and variant not in ("average", "round_colearn"):
        rec["profile"] = profile_costs(cfg, shape, mesh, multi_pod, variant)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--profile-meshes", default="single",
                    help="comma list of meshes to run the profile phase on")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    prof_meshes = set(args.profile_meshes.split(","))
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            kind = INPUT_SHAPES[shape_name].kind
            for mesh_kind in meshes:
                for variant in VARIANTS[kind][mesh_kind]:
                    tag = f"{arch}__{shape_name}__{mesh_kind}__{variant}"
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path):
                        print(f"[skip cached] {tag}", flush=True)
                        n_ok += 1
                        continue
                    try:
                        rec = run_one(arch, shape_name, mesh_kind, variant,
                                      profile=(not args.no_profile and
                                               mesh_kind in prof_meshes))
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        pk = rec["memory"]["peak_bytes_per_device"] / 2 ** 30
                        fl = rec.get("profile", rec["scan_raw_cost"])["flops"]
                        print(f"[ok {rec['compile_s']:6.1f}s] {tag} "
                              f"flops/dev={fl:.3e} peak={pk:.2f}GiB",
                              flush=True)
                        n_ok += 1
                    except Exception as e:
                        n_fail += 1
                        with open(path + ".fail", "w") as f:
                            f.write(traceback.format_exc())
                        print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                              flush=True)
    print(f"dry-run done: {n_ok} ok, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
