"""The pod path of the port (one process per participant over
``torch.distributed``) against the simulation path, on the CPU.

One module fixture starts K = 4 ranks over gloo: ``subprocess`` workers
(one torch thread each, a ``file://`` rendezvous in the test's tmp dir)
that import no JAX. Each runs every check of ``WORKER`` once on its own
row of the same numpy inputs and writes its results to an npz; the parent
holds them against the JAX package's simulation functions and the port's
simulation path on the same inputs. The checks mirror the reference's
pod-mesh ``SCRIPT`` (``tests/test_sharding.py`` items 2-4f), which cannot
run under this jax: the pod path is held where that test holds the
reference, against the simulation path, at its 1e-5 mesh-vs-host bound.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import CoLearnConfig as JCoLearnConfig
from repro.core import api as japi
from repro.core import averaging as javg
from repro.core import engine as jengine
from repro.core import flatbuf as jfb
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim.optimizers import get_optimizer as jget_optimizer
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api as tapi
from repro_torch.core import averaging as tavg
from repro_torch.core import flatbuf as tfb
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.sharding import specs as tspecs
from repro_torch.tree import leaves, leaves_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
K, T, NB, B, S = 4, 2, 2, 2, 8
TOL = 1e-5            # the reference's mesh-vs-host bound (test_sharding)
# round trajectories: the port's JAX-parity bound (tests/test_torch_engine)
LOG_TOL = {"rtol": 1e-5, "atol": 1e-6}
WEIGHTS = (3.0, 1.0, 2.0, 2.0)
MASK = np.array([[True, True], [True, False], [True, True], [False, True]])
LIVE = np.array([1.0, 0.0, 1.0, 1.0], np.float32)       # rank 1 is dead
ROUNDS = 2


def _cfg(get):
    return get("internlm2-1.8b").with_(n_layers=1,
                                       segments=((("gqa:dense",), 1),))


WORKER = r"""
import sys
import numpy as np
import torch

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
from repro_torch.checkpoint.io import restore_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api, averaging, flatbuf
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import transformer as tr
from repro_torch.sharding import specs
from repro_torch.tree import leaves_with_path, tree_map

K, ROUNDS = world, int(sys.argv[4])
M.init_process_mesh(rank, world, f"file://{d}/rdv", "gloo", "cpu")
mesh = M.make_sim_mesh((K, 1, 1), ("pod", "data", "model"), "cpu")
cfg = get_smoke_config("internlm2-1.8b").with_(
    n_layers=1, segments=((("gqa:dense",), 1),))
like = averaging.stack_participants(
    tr.init_params(0, cfg, torch.float32, device="cpu"), K)
full = restore_pytree(f"{d}/stacked.npz", like)
corr_full = restore_pytree(f"{d}/corr.npz", like)
inp = dict(np.load(f"{d}/inputs.npz"))
row = lambda tree: tree_map(lambda t: t[rank:rank + 1].clone(), tree)
out = {}


def put(name, tree):
    for path, t in leaves_with_path(tree):
        out[f"{name}/{path}"] = t.detach().numpy().copy()


def batches(n_epochs=2):
    return {k: torch.as_tensor(inp[k][:n_epochs, rank:rank + 1])
            for k in ("tokens", "labels")}


W = {n: torch.as_tensor(inp[f"W_{n}"]) for n in
     ("uniform", "weighted", "partial", "hypercube", "grid2d", "ring",
      "exponential", "live")}
live_row = torch.as_tensor(inp["live"])

# 2) colearn step: each rank steps its own replica
cstep = steps.make_colearn_train_step(cfg, lr=0.01)
b0 = {k: torch.as_tensor(inp[k][0, rank:rank + 1, 0])
      for k in ("tokens", "labels")}
new_row, loss = cstep(row(full), b0)
put("colearn", new_row)
out["colearn_loss"] = loss.numpy()

# 3) explicit all-reduce averaging
sm = averaging.make_average_shard_map(
    mesh, specs.param_specs(row(full), cfg, mesh, participant=True))
put("avg", sm(row(full)))

# 4b) flat int8 (K1 + K2 + one all-reduce) and its K1 row
agg = api.FullAverage().make_aggregate_fn(api.FlatFusedInt8(), mesh=mesh)
put("flat8", agg(row(full)))
out["flat8_dense"] = np.array(agg.dense_fallback)
out["flat8_bytes"] = np.array(agg.pod.stats["all_reduce_bytes"])
local = row(full)
lay = flatbuf.make_layout(local)
for bits in (8, 4, 1):
    q, s, _ = ops.quantize_blockwise(flatbuf.flatten(local, lay), bits=bits)
    out[f"codes{bits}"], out[f"scales{bits}"] = q.numpy(), s.numpy()

# 4c) leaf-wise int8, the roundtrip per rank in front of the all-reduce
agg = api.FullAverage().make_aggregate_fn(api.LeafwiseInt8(), mesh=mesh)
put("leaf8", agg(row(full)))

# 4d/4f) weighted psum, permutes, D2 and a dense fallback
for name, a, w in (("partial", api.PartialParticipation(m=2, seed=0),
                    "partial"),
                   ("weighted", api.FullAverage(weights=(3.0, 1.0, 2.0,
                                                         2.0)), "weighted"),
                   ("ring", api.RingGossip(), "ring"),
                   ("hypercube", api.GraphGossip("hypercube"), "hypercube"),
                   ("grid2d", api.GraphGossip("grid2d"), "grid2d"),
                   ("exponential", api.GraphGossip("exponential"),
                    "exponential")):
    codec = api.FlatFusedInt8() if name == "exponential" else api.ExactF32()
    fn = a.make_aggregate_fn(codec, mesh=mesh)
    put(name, fn(row(full), W[w]))
    out[f"{name}_dense"] = np.array(fn.dense_fallback)
    out[f"{name}_legs"] = np.array(fn.pod.stats["p2p_legs"])
d2 = api.D2Gossip("hypercube").make_aggregate_fn(api.ExactF32(), mesh=mesh)
mixed, corr = d2(row(full), W["hypercube"], row(corr_full))
put("d2", mixed)
put("d2corr", corr)
out["d2_dense"] = np.array(d2.dense_fallback)
d2ef = api.D2Gossip("ring").make_aggregate_fn(
    api.FlatFusedIntN(bits=4, error_feedback=True), mesh=mesh)
st = api.D2Gossip("ring").init_round_state(
    api.FlatFusedIntN(bits=4, error_feedback=True), row(full))
mixed, st = d2ef(row(full), W["ring"], st)
put("d2ef", mixed)
put("d2efcorr", st["corr"])
out["d2ef_res"] = st["res"].numpy()
out["d2ef_dense"] = np.array(d2ef.dense_fallback)

# 4e) the weighted flat fused mean
wflat = api.FlatFusedInt8().make_fused_mean(mesh=mesh, weighted=True)
put("wflat", wflat(row(full), W["weighted"][0]))

# 4f) bits: IntN(8) == Int8, int4 flat and leaf-wise, int4 error feedback
for name, codec in (("flatN8", api.FlatFusedIntN(bits=8)),
                    ("leafN8", api.LeafwiseIntN(bits=8)),
                    ("flat4", api.FlatFusedIntN(bits=4)),
                    ("leaf4", api.LeafwiseIntN(bits=4))):
    put(name, api.FullAverage().make_aggregate_fn(codec, mesh=mesh)(
        row(full)))
ef = api.FlatFusedIntN(bits=4, error_feedback=True)
res0 = ef.init_state(row(full))
mixed, res = api.FullAverage().make_aggregate_fn(ef, mesh=mesh)(
    row(full), None, res0)
put("ef4", mixed)
out["ef4_res"] = res.numpy()
lef = api.LeafwiseIntN(bits=4, error_feedback=True)
mixed, res = api.FullAverage().make_aggregate_fn(lef, mesh=mesh)(
    row(full), None, lef.init_state(row(full)))
put("lef4", mixed)
put("lef4res", res)

# the gated finalize on the pod: the divergence sums over every rank's
# rows (one scalar all-reduce), so every rank takes the same decision
from repro_torch.core import engine
from repro_torch.optim.optimizers import get_optimizer
ref_row = tree_map(lambda t: t[0].clone(), full)
for name, delta in (("gsync", 0.0), ("gquiet", 1e9)):
    gfin = engine.make_fused_finalize(
        get_optimizer("sgd"), gated=True, aggregate_fn=api.FullAverage()
        .make_aggregate_fn(api.FlatFusedInt8(), mesh=mesh))
    p_, _, rel, div, synced, new_ref = gfin(
        row(full), (), tree_map(torch.clone, ref_row), torch.tensor(delta))
    put(name, p_)
    put(name + "_ref", new_ref)
    out[name + "_div"] = div.numpy()
    out[name + "_synced"] = np.array(bool(synced))
    out[name + "_rel"] = rel.numpy()

# one row per pod and a matrix over the pod's K: a (2, ...) local stack
# and a (3, 3) matrix are refused
two = tree_map(lambda t: t[:2].clone(), full)
refused = 0
for fn, args in ((api.FullAverage().make_aggregate_fn(api.FlatFusedInt8(),
                                                       mesh=mesh),
                  (two, W["ring"])),
                 (api.RingGossip().make_aggregate_fn(api.ExactF32(),
                                                     mesh=mesh),
                  (two, W["ring"])),
                 (api.FullAverage(weights=(1.0,) * K).make_aggregate_fn(
                     api.ExactF32(), mesh=mesh),
                  (row(full), torch.full((3, 3), 1 / 3)))):
    try:
        fn(*args)
    except ValueError:
        refused += 1
out["refused"] = np.array(refused)

# 4/4f) the fused round step on the pod: fused int8, int4 + error
# feedback, the weighted masked round, and a live round with rank 1 dead
ccfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.05, max_rounds=ROUNDS)
for name, kw in (("round8", {"codec": "fused"}),
                 ("roundef", {"codec": "fused", "codec_bits": 4,
                              "error_feedback": True}),
                 ("roundmask", {"aggregator": api.FullAverage(
                     weights=(3.0, 1.0, 2.0, 2.0)), "masked": True}),
                 ("roundlive", {"codec": "fused", "live": True})):
    rf = steps.make_fused_round_step(cfg, ccfg, mesh=mesh, **kw)
    params, opt = row(full), ()
    state = (() if not kw.get("error_feedback") else
             (api.FlatFusedIntN(bits=4, error_feedback=True)
              .init_state(params),))
    for i in range(ROUNDS):
        args = list(state) + [batches()]
        if kw.get("masked"):
            args.append(torch.as_tensor(inp["mask"][rank:rank + 1]))
        if kw.get("live"):
            args.append(live_row)
        args.append(i * 2)
        if kw.get("masked"):
            args.append(W["weighted"])
        if kw.get("live"):
            args.append(W["live"])
        params, opt, aux = rf(params, opt, *args)
        if kw.get("error_feedback"):
            state = (aux["residual"],)
        out[f"{name}_losses{i}"] = aux["losses"].numpy()
        out[f"{name}_rel{i}"] = aux["rel"].numpy()
        put(f"{name}@{i}", params)
        put(f"{name}_avg@{i}", aux["new_avg"])
        if kw.get("error_feedback"):
            out[f"{name}_res@{i}"] = aux["residual"].numpy().copy()
    put(name, params)
    put(name + "_avg", aux["new_avg"])
    if kw.get("error_feedback"):
        out[name + "_res"] = aux["residual"].numpy().copy()

# engine.make_fused_round(spmd_axis_name="pod") itself: round8's first
# round, from the same rows and shared model
rnd = engine.make_fused_round(
    lambda p, b: tr.loss_fn(p, cfg, b), get_optimizer("sgd"),
    spmd_axis_name="pod", aggregate_fn=api.FullAverage().make_aggregate_fn(
        api.FlatFusedInt8(), mesh=mesh))
sched = api.get_schedule(None, ccfg).device_round_params(0, "cpu")
params, _, aux = rnd(row(full), (), batches(), tree_map(torch.clone, ref_row),
                     torch.tensor(0, dtype=torch.int32), sched,
                     torch.tensor(2 * ROUNDS, dtype=torch.int32))
put("engine_round", params)
out["engine_round_losses"] = aux["losses"].numpy()
out["engine_round_rel"] = aux["rel"].numpy()
np.savez(f"{d}/out{rank}.npz", **out)
"""


def _paths(jtree):
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(v)) for path, v in flat]


def _save_npz(path, jtree):
    np.savez(path, **dict(_paths(jtree)))


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod")
    jcfg = _cfg(jget_smoke_config)
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    # K distinct rows: the shared init plus each participant's drift
    stacked = jax.tree.map(
        lambda t: jnp.asarray(np.asarray(t)[None] + 0.02 * rng.standard_normal(
            (K, *t.shape)).astype(np.float32)), params)
    corr = jax.tree.map(lambda t: jnp.asarray(
        0.01 * rng.standard_normal(t.shape).astype(np.float32)), stacked)
    _save_npz(d / "stacked.npz", stacked)
    _save_npz(d / "corr.npz", corr)
    tokens = rng.integers(0, jcfg.vocab_size, (T, K, NB, B, S), np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (T, K, NB, B, S), np.int32)
    Ws = {
        "uniform": japi.FullAverage().mixing_matrix(0, K),
        "weighted": japi.FullAverage(weights=WEIGHTS).mixing_matrix(0, K),
        "partial": japi.PartialParticipation(m=2, seed=0).mixing_matrix(
            0, K),
        "hypercube": japi.GraphGossip("hypercube").mixing_matrix(0, K),
        "grid2d": japi.GraphGossip("grid2d").mixing_matrix(0, K),
        "ring": japi.RingGossip().mixing_matrix(0, K),
        "exponential": japi.GraphGossip("exponential").mixing_matrix(0, K),
        "live": japi.FullAverage().mixing_matrix(0, K, live=LIVE > 0),
    }
    np.savez(d / "inputs.npz", tokens=tokens, labels=labels, mask=MASK,
             live=LIVE, **{f"W_{n}": np.asarray(w, np.float32)
                           for n, w in Ws.items()})
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(k), str(K), str(d), str(ROUNDS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(K)]
    try:
        ref = _reference(jcfg, params, stacked, corr, tokens, labels, Ws)
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, errs[0]
    ranks = [dict(np.load(d / f"out{k}.npz")) for k in range(K)]
    return {"ranks": ranks, "ref": ref, "stacked": stacked, "Ws": Ws,
            "params": params, "tokens": tokens, "labels": labels}


def _reference(jcfg, params, stacked, corr, tokens, labels, Ws):
    """The JAX package's simulation-path results on the same inputs."""
    out = {}
    step = jax.jit(jax.vmap(jsteps.make_train_step(jcfg, lr=0.01)))
    new, losses = step(stacked, {"tokens": tokens[0, :, 0],
                                 "labels": labels[0, :, 0]})
    out["colearn"], out["colearn_loss"] = new, losses
    out["avg"] = javg.average_pjit(stacked)
    out["flat8"] = japi.FullAverage().make_aggregate_fn(
        japi.FlatFusedInt8(impl="ref"))(stacked)
    out["flatN8"] = out["flat8"]
    out["flat4"] = japi.FullAverage().make_aggregate_fn(
        japi.FlatFusedIntN(bits=4, impl="ref"))(stacked)

    # the reference's pod path roundtrips each pod's own (1, ...) row
    # (eagerly: under jit XLA may divide by the scale another way and
    # flip a rounding of the int4 quantizer)
    def rowwise(codec):
        rows = [codec.roundtrip(jax.tree.map(lambda t, _k=k: t[_k:_k + 1],
                                             stacked)) for k in range(K)]
        return javg.average_pjit(jax.tree.map(
            lambda *xs: jnp.concatenate(xs), *rows))
    out["leaf8"] = rowwise(japi.LeafwiseInt8(impl="ref"))
    out["leafN8"] = out["leaf8"]
    out["leaf4"] = rowwise(japi.LeafwiseIntN(bits=4, impl="ref"))
    W = {n: jnp.asarray(w) for n, w in Ws.items()}
    for name, agg, w in (
            ("partial", japi.PartialParticipation(m=2, seed=0), "partial"),
            ("weighted", japi.FullAverage(weights=WEIGHTS), "weighted"),
            ("ring", japi.RingGossip(), "ring"),
            ("hypercube", japi.GraphGossip("hypercube"), "hypercube"),
            ("grid2d", japi.GraphGossip("grid2d"), "grid2d")):
        out[name] = agg._make_host_aggregate_fn(japi.ExactF32())(stacked,
                                                                 W[w])
    out["exponential"] = japi.GraphGossip("exponential") \
        ._make_host_aggregate_fn(japi.FlatFusedInt8(impl="ref"))(
            stacked, W["exponential"])
    out["d2"], out["d2corr"] = japi.D2Gossip("hypercube") \
        ._make_host_aggregate_fn(japi.ExactF32())(stacked, W["hypercube"],
                                                  corr)
    efc = japi.FlatFusedIntN(bits=4, error_feedback=True, impl="ref")
    d2 = japi.D2Gossip("ring")
    mixed, st = d2._make_host_aggregate_fn(efc)(
        stacked, W["ring"], d2.init_round_state(efc, stacked))
    out["d2ef"], out["d2efcorr"], out["d2ef_res"] = mixed, st["corr"], \
        st["res"]
    out["wflat"] = japi.FlatFusedInt8(impl="ref").make_fused_mean(
        weighted=True)(stacked, W["weighted"][0])
    out["ef4"], out["ef4_res"] = japi.FullAverage().make_aggregate_fn(efc)(
        stacked, None, efc.init_state(stacked))
    # leaf-wise error feedback per pod row, the reference's pod roundtrip
    lef = japi.LeafwiseIntN(bits=4, error_feedback=True, impl="ref")
    rts = [lef.roundtrip_ef(
        jax.tree.map(lambda t, _k=k: t[_k:_k + 1], stacked),
        jax.tree.map(lambda t, _k=k: jnp.zeros((1, *t.shape[1:]),
                                                jnp.float32), stacked))
        for k in range(K)]
    out["lef4"] = javg.average_pjit(jax.tree.map(
        lambda *xs: jnp.concatenate(xs), *[r[0] for r in rts]))
    out["lef4res"] = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                                  *[r[1] for r in rts])
    gagg = japi.FullAverage().make_aggregate_fn(
        japi.FlatFusedInt8(impl="ref"))
    sync_ref = jax.tree.map(lambda t: t[0], stacked)
    for name, delta in (("gsync", 0.0), ("gquiet", 1e9)):
        gfin = jengine.make_fused_finalize(
            jget_optimizer("sgd"), aggregate_fn=gagg, gated=True,
            donate=False)
        p_, _, rel, div, synced, new_ref = gfin(stacked, (), sync_ref,
                                                jnp.float32(delta))
        out[name], out[name + "_ref"] = p_, new_ref
        out[name + "_div"], out[name + "_synced"] = float(div), bool(synced)
        out[name + "_rel"] = float(rel)
    out.update(_reference_rounds(jcfg, stacked, tokens, labels, W))
    return out


def _reference_rounds(jcfg, stacked, tokens, labels, W):
    ccfg = JCoLearnConfig(n_participants=K, T0=2, eta0=0.05,
                          max_rounds=ROUNDS)
    sched_obj = japi.get_schedule(None, ccfg)
    opt = jget_optimizer("sgd")

    def loss_fn(p, b):
        return jtr.loss_fn(p, jcfg, b, "scan", "ref", True)
    batches = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    efc = japi.FlatFusedIntN(bits=4, error_feedback=True, impl="ref")
    out = {}
    for name, codec, agg, kw in (
            ("round8", japi.FlatFusedInt8(impl="ref"), japi.FullAverage(),
             {}),
            ("roundef", efc, japi.FullAverage(), {"stateful": True}),
            ("roundmask", japi.ExactF32(), japi.FullAverage(weights=WEIGHTS),
             {"masked": True}),
            ("roundlive", japi.FlatFusedInt8(impl="ref"), japi.FullAverage(),
             {"live": True})):
        fn = agg.make_aggregate_fn(codec, dynamic=kw.get("live", False))
        rnd = jengine.make_fused_round(
            loss_fn, opt, lr_fn=japi.traced_body(sched_obj),
            aggregate_fn=fn, donate=False, **kw)
        params, ostate = stacked, ()
        res = (efc.init_state(stacked),) if kw.get("stateful") else ()
        for i in range(ROUNDS):
            extra = ()
            if kw.get("masked"):
                extra += (jnp.asarray(MASK),)
            if kw.get("live"):
                extra += (jnp.asarray(LIVE),)
            tail = ((W["weighted"],) if kw.get("masked") else
                    (W["live"],) if kw.get("live") else ())
            params, ostate, aux = rnd(
                params, ostate, *res, batches, *extra, jnp.int32(2 * i),
                sched_obj.device_round_params(0), jnp.int32(2 * ROUNDS),
                *tail)
            if kw.get("stateful"):
                res = (aux["residual"],)
            out[f"{name}_losses{i}"] = np.asarray(aux["losses"])
            out[f"{name}_rel{i}"] = float(aux["rel"])
        out[name] = params
        out[name + "_avg"] = aux["new_avg"]
        if kw.get("stateful"):
            out[name + "_res"] = aux["residual"]
    return out


def _rank_tree(rank_out, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


def _max_diff_row(pod, name, k, want_tree, unstacked=False):
    got = _rank_tree(pod["ranks"][k], name)
    want = dict(_paths(want_tree))
    assert got.keys() == want.keys(), name
    if unstacked:
        return max(float(np.abs(got[p] - w).max()) for p, w in want.items())
    return max(float(np.abs(got[p][0] - w[k]).max())
               for p, w in want.items())


def _ranks_equal(pod, name):
    trees = [_rank_tree(r, name) for r in pod["ranks"]]
    return all(np.array_equal(trees[0][p], t[p]) for t in trees[1:]
               for p in trees[0])


def _int8_bounds(stacked):
    return {p: float(np.abs(np.asarray(v)).max()) / 127.0 + 1e-6
            for p, v in _paths(stacked)}


def test_colearn_replicas_independent(pod):
    for k in range(K):
        assert _max_diff_row(pod, "colearn", k, pod["ref"]["colearn"]) \
            <= TOL
        np.testing.assert_allclose(pod["ranks"][k]["colearn_loss"],
                                   np.asarray(pod["ref"]["colearn_loss"])[k],
                                   rtol=TOL)
    a, b = (_rank_tree(pod["ranks"][k], "colearn") for k in (0, 1))
    assert max(float(np.abs(a[p] - b[p]).max()) for p in a) > 0


def test_average_shard_map_matches_average_pjit(pod):
    for k in range(K):
        assert _max_diff_row(pod, "avg", k, pod["ref"]["avg"]) <= TOL
    assert _ranks_equal(pod, "avg")


@pytest.mark.parametrize("name", ["flat8", "leaf8"])
def test_int8_pod_means_within_bound_and_ranks_equal(pod, name):
    """Against the exact mean within the int8 bound (the reference's
    check), against the simulation path's wire at 1e-5, every rank's
    average equal bit for bit."""
    bounds = _int8_bounds(pod["stacked"])
    exact = dict(_paths(pod["ref"]["avg"]))
    got = _rank_tree(pod["ranks"][0], name)
    for p, b in bounds.items():
        assert float(np.abs(got[p][0] - exact[p][0]).max()) <= b
    for k in range(K):
        assert _max_diff_row(pod, name, k, pod["ref"][name]) <= TOL
    assert _ranks_equal(pod, name)
    if name == "flat8":
        assert not pod["ranks"][0]["flat8_dense"]
        n_pad = jfb.make_layout(pod["stacked"]).n_pad
        assert float(pod["ranks"][0]["flat8_bytes"]) == 4 * n_pad


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_k1_codes_bit_exact_per_row(pod, bits):
    """Each rank's K1 over its (1, N_pad) row equals row k of K1 over the
    simulation path's (K, N_pad) buffer (the port's and the JAX oracle's)."""
    jbuf = jfb.flatten(pod["stacked"], jfb.make_layout(pod["stacked"]))
    jq, js, _ = jref.quantize_blockwise_ref(jbuf, bits=bits)
    tstack = params_from_numpy(jax.tree.map(np.asarray, pod["stacked"]),
                               "cpu")
    tq, ts, _ = tops.quantize_blockwise(
        tfb.flatten(tstack, tfb.make_layout(tstack)), bits=bits)
    rows = jq.shape[0] // K
    for k in range(K):
        q, s = pod["ranks"][k][f"codes{bits}"], pod["ranks"][k][
            f"scales{bits}"]
        np.testing.assert_array_equal(q, np.asarray(jq)[k * rows:
                                                        (k + 1) * rows])
        if bits == 1:      # mean|x|: XLA and torch sum a row in two orders
            np.testing.assert_allclose(s, np.asarray(js)[k * rows:
                                                         (k + 1) * rows],
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(s, np.asarray(js)[k * rows:
                                                            (k + 1) * rows])
        np.testing.assert_array_equal(q, tq[k * rows:(k + 1) * rows].numpy())
        np.testing.assert_array_equal(s, ts[k * rows:(k + 1) * rows].numpy())


@pytest.mark.parametrize("name", ["weighted", "partial", "wflat"])
def test_weighted_aggregators_on_pod(pod, name):
    for k in range(K):
        assert _max_diff_row(pod, name, k, pod["ref"][name]) <= TOL
    assert _ranks_equal(pod, name)


@pytest.mark.parametrize("name,legs", [("ring", 1), ("hypercube", 2),
                                       ("grid2d", 2)])
def test_gossip_permutes_on_pod(pod, name, legs):
    """One point-to-point exchange per edge permutation (the sparse path
    engaged: no dense fallback)."""
    for k in range(K):
        assert _max_diff_row(pod, name, k, pod["ref"][name]) <= TOL
        assert not pod["ranks"][k][f"{name}_dense"]
        assert int(pod["ranks"][k][f"{name}_legs"]) == legs


def test_d2_gossip_on_pod(pod):
    for k in range(K):
        assert _max_diff_row(pod, "d2", k, pod["ref"]["d2"]) <= TOL
        assert _max_diff_row(pod, "d2corr", k, pod["ref"]["d2corr"]) <= TOL
        assert not pod["ranks"][k]["d2_dense"]


def test_dense_fallbacks_are_flagged_and_match(pod):
    """A time-varying graph and D² over an error-feedback codec take the
    dense fallback (one broadcast from each rank), flagged."""
    for k in range(K):
        assert pod["ranks"][k]["exponential_dense"]
        assert pod["ranks"][k]["d2ef_dense"]
        assert _max_diff_row(pod, "exponential", k,
                             pod["ref"]["exponential"]) <= TOL
        for name in ("d2ef", "d2efcorr"):
            assert _max_diff_row(pod, name, k, pod["ref"][name]) <= TOL
        np.testing.assert_allclose(pod["ranks"][k]["d2ef_res"][0],
                                   np.asarray(pod["ref"]["d2ef_res"])[k],
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["flatN8", "leafN8", "flat4", "leaf4"])
def test_sub_int8_wire_on_pod(pod, name):
    for k in range(K):
        assert _max_diff_row(pod, name, k, pod["ref"][name]) <= TOL
    base = {"flatN8": "flat8", "leafN8": "leaf8"}.get(name)
    if base is not None:       # IntN at 8 bits is the int8 codec, bitwise
        a, b = (_rank_tree(pod["ranks"][0], n) for n in (name, base))
        assert all(np.array_equal(a[p], b[p]) for p in a)


def test_error_feedback_residual_stays_on_its_rank(pod):
    exact_res = np.asarray(pod["ref"]["ef4_res"])
    for k in range(K):
        assert _max_diff_row(pod, "ef4", k, pod["ref"]["ef4"]) <= TOL
        res = pod["ranks"][k]["ef4_res"]
        assert res.shape == (1, exact_res.shape[1])
        np.testing.assert_allclose(res[0], exact_res[k], atol=1e-6)
        assert np.abs(res).max() > 0
        assert _max_diff_row(pod, "lef4", k, pod["ref"]["lef4"]) <= TOL
        assert _max_diff_row(pod, "lef4res", k, pod["ref"]["lef4res"]) \
            <= 1e-6
    assert _ranks_equal(pod, "ef4")


def _quantum(stacked, bits):
    """One wire quantum of the mean (tests/test_torch_engine.py): a last-bit
    difference in the epochs may flip one rounding of the quantizer."""
    buf = jfb.flatten(stacked, jfb.make_layout(stacked))
    _, scale, _ = jref.quantize_blockwise_ref(buf, bits=bits)
    live = jnp.abs(buf.reshape(-1, 256)).max(axis=1) > 0
    return float(jnp.max(jnp.where(live, scale, 0.0))) / K


ROUND_BITS = {"round8": 8, "roundef": 4, "roundmask": None, "roundlive": 8}


@pytest.mark.parametrize("name", ["round8", "roundef", "roundmask",
                                  "roundlive"])
def test_fused_round_step_on_pod_matches_simulation(pod, name):
    """``make_fused_round_step(mesh=)`` for two rounds against the port's
    own simulation-path step (the same wire, only the K-term sum in
    another order: losses, rel, params and residual at 1e-5) and against
    the JAX package's ``engine.make_fused_round`` without a pod axis (the
    first round's losses; the params at 1e-5 over the exact wire, within
    one wire quantum over a quantized one, as the port's JAX parity
    tests hold them)."""
    ref = pod["ref"]
    sim = _port_sim_rounds(pod, name)
    for k in range(K):
        r = pod["ranks"][k]
        np.testing.assert_allclose(r[f"{name}_losses0"],
                                   ref[f"{name}_losses0"], **LOG_TOL)
        for i in range(ROUNDS):
            np.testing.assert_allclose(r[f"{name}_losses{i}"],
                                       sim[i]["losses"], **LOG_TOL)
            np.testing.assert_allclose(float(r[f"{name}_rel{i}"]),
                                       sim[i]["rel"], **LOG_TOL)
            got = _rank_tree(r, f"{name}@{i}")
            assert max(float(np.abs(got[p][0] - sim[i]["params"][p][k])
                             .max()) for p in got) <= TOL
            avg = _rank_tree(r, f"{name}_avg@{i}")
            assert max(float(np.abs(avg[p] - sim[i]["new_avg"][p]).max())
                       for p in avg) <= TOL
            if name == "roundef":
                np.testing.assert_allclose(r[f"{name}_res@{i}"][0],
                                           sim[i]["residual"][k], atol=TOL)
    bits = ROUND_BITS[name]
    if bits is None:
        for k in range(K):
            r = pod["ranks"][k]
            for i in range(ROUNDS):
                np.testing.assert_allclose(r[f"{name}_losses{i}"],
                                           ref[f"{name}_losses{i}"],
                                           **LOG_TOL)
                np.testing.assert_allclose(float(r[f"{name}_rel{i}"]),
                                           ref[f"{name}_rel{i}"], **LOG_TOL)
    tol = TOL if bits is None else _quantum(ref[name], bits)
    for k in range(K):
        assert _max_diff_row(pod, name, k, ref[name]) <= tol
        assert _max_diff_row(pod, name + "_avg", k, ref[name + "_avg"],
                             unstacked=True) <= tol
    if name == "roundef":
        for k in range(K):
            res = pod["ranks"][k]["roundef_res"]
            np.testing.assert_allclose(res[0],
                                       np.asarray(ref["roundef_res"])[k],
                                       atol=tol)
            assert np.abs(res).max() > 0
    if name == "roundlive":
        # the dead rank's row is unchanged bit for bit; the live ones
        # hold the same shared model
        got = _rank_tree(pod["ranks"][1], name)
        start = dict(_paths(pod["stacked"]))
        assert all(np.array_equal(got[p][0], start[p][1]) for p in got)
        live = [_rank_tree(pod["ranks"][k], name) for k in (0, 2, 3)]
        assert all(np.array_equal(live[0][p], t[p]) for t in live[1:]
                   for p in live[0])
    else:
        assert _ranks_equal(pod, name)


def _port_sim_rounds(pod, name):
    """The port's simulation-path step (``mesh=None``) on the stacked K,
    on one thread as the ranks run (a CPU matmul's sum order depends on
    its thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_sim_rounds_1(pod, name)
    finally:
        torch.set_num_threads(threads)


def _port_sim_rounds_1(pod, name):
    cfg = _cfg(get_smoke_config)
    ccfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.05,
                         max_rounds=ROUNDS)
    kw = {"round8": {"codec": "fused"},
          "roundef": {"codec": "fused", "codec_bits": 4,
                      "error_feedback": True},
          "roundmask": {"aggregator": tapi.FullAverage(weights=WEIGHTS),
                        "masked": True},
          "roundlive": {"codec": "fused", "live": True}}[name]
    rf = tsteps.make_fused_round_step(cfg, ccfg, device="cpu", **kw)
    batches = {"tokens": torch.as_tensor(pod["tokens"]),
               "labels": torch.as_tensor(pod["labels"])}
    rounds = []
    for i in range(ROUNDS):
        # each round starts where the pod's last one ended: a last-bit
        # difference (the K-term sum's order) would otherwise flip
        # roundings of the next round's quantizer
        if i == 0:
            params = params_from_numpy(
                jax.tree.map(np.asarray, pod["stacked"]), "cpu")
        else:
            rows = [_rank_tree(r, f"{name}@{i - 1}") for r in pod["ranks"]]
            params = params_from_numpy(
                {p: np.concatenate([r[p] for r in rows]) for p in rows[0]},
                "cpu")
            params = _unflat_like(pod["stacked"], params)
        state = ()
        if kw.get("error_feedback"):
            state = ((tapi.FlatFusedIntN(bits=4, error_feedback=True)
                      .init_state(params),) if i == 0 else
                     (torch.as_tensor(np.concatenate(
                         [r[f"{name}_res@{i - 1}"] for r in pod["ranks"]])),))
        args = list(state) + [batches]
        if kw.get("masked"):
            args.append(torch.as_tensor(MASK))
        if kw.get("live"):
            args.append(torch.as_tensor(LIVE))
        args.append(2 * i)
        if kw.get("masked"):
            args.append(torch.as_tensor(pod["Ws"]["weighted"]))
        if kw.get("live"):
            args.append(torch.as_tensor(pod["Ws"]["live"]))
        params, _, aux = rf(params, (), *args)
        one = {"losses": aux["losses"].numpy(), "rel": float(aux["rel"]),
               "params": {p: t.numpy() for p, t in leaves_with_path(params)},
               "new_avg": {p: t.numpy() for p, t in leaves_with_path(
                   aux["new_avg"])}}
        if kw.get("error_feedback"):
            one["residual"] = aux["residual"].numpy().copy()
        rounds.append(one)
    return rounds


def _unflat_like(jtree, flat):
    """A path-keyed dict of tensors in the structure of ``jtree``."""
    from repro_torch.tree import unflatten_like
    like = jax.tree.map(np.asarray, jtree)
    return unflatten_like(like, [flat[p] for p, _ in _paths(jtree)])


@pytest.mark.parametrize("name", ["gsync", "gquiet"])
def test_gated_finalize_on_pod(pod, name):
    """The divergence gate over every rank's rows: the JAX package's
    divergence and decision on every rank, then its synced average (or
    the rows and reference untouched on a quiet round)."""
    ref = pod["ref"]
    for k in range(K):
        r = pod["ranks"][k]
        np.testing.assert_allclose(float(r[name + "_div"]),
                                   ref[name + "_div"], **LOG_TOL)
        assert bool(r[name + "_synced"]) == ref[name + "_synced"]
        assert _max_diff_row(pod, name, k, ref[name]) <= TOL
        assert _max_diff_row(pod, name + "_ref", k, ref[name + "_ref"],
                             unstacked=True) <= TOL
    assert ref["gsync_synced"] and not ref["gquiet_synced"]


def test_engine_round_on_pod_is_the_step_round(pod):
    """``engine.make_fused_round(spmd_axis_name="pod")`` equals the step's
    first round from the same rows (the step captures its epochs)."""
    for r in pod["ranks"]:
        a, b = _rank_tree(r, "engine_round"), _rank_tree(r, "round8@0")
        assert all(np.array_equal(a[p], b[p]) for p in a)
        np.testing.assert_array_equal(r["engine_round_losses"],
                                      r["round8_losses0"])
        np.testing.assert_array_equal(r["engine_round_rel"],
                                      r["round8_rel0"])


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch):
    """``make_train_step`` (and its gradient accumulation) against the
    reference's on the same params and batch; the co-learning step runs
    each row alone."""
    jcfg, tcfg = _cfg(jget_smoke_config), _cfg(get_smoke_config)
    params = jtr.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 8), np.int32)
             for k in ("tokens", "labels")}
    jnew, jloss = jax.jit(jsteps.make_train_step(
        jcfg, lr=0.05, microbatch=microbatch))(params, batch)
    tnew, tloss = tsteps.make_train_step(tcfg, lr=0.05,
                                         microbatch=microbatch)(
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **LOG_TOL)
    want = dict(_paths(jnew))
    for p, t in leaves_with_path(tnew):
        np.testing.assert_allclose(t.numpy(), want[p], rtol=0, atol=TOL)
    stacked = tavg.stack_participants(params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), 2)
    cnew, closs = tsteps.make_colearn_train_step(tcfg, lr=0.05)(
        stacked, {k: torch.as_tensor(np.stack([v, v]))
                  for k, v in batch.items()})
    assert closs.shape == (2,) and float(closs[0]) == float(closs[1])
    assert tsteps.make_average_step() is tavg.average_pjit


def test_step_spellings_agree():
    """The compact signature (the schedule pack baked for ``round_index``)
    equals ``expose_schedule_args=True`` fed the same pack, and the
    legacy ``compress="fused"`` equals ``codec="fused"``."""
    cfg = _cfg(get_smoke_config)
    ccfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.05, max_rounds=3)
    params = params_from_numpy(jax.tree.map(np.asarray, jtr.init_params(
        jax.random.PRNGKey(2), _cfg(jget_smoke_config), jnp.float32)), "cpu")
    rng = np.random.default_rng(2)
    batches = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                               (1, 2, 1, 2, 8), np.int32))
               for k in ("tokens", "labels")}
    outs = []
    for kw, extra in (({"codec": "fused"}, ()),
                      ({"compress": "fused"}, ()),
                      ({"codec": "fused", "expose_schedule_args": True},
                       (tapi.get_schedule(None, ccfg).device_round_params(
                           0, "cpu"), 3))):
        rf = tsteps.make_fused_round_step(cfg, ccfg, device="cpu", **kw)
        p, _, aux = rf(tavg.stack_participants(params, 2), (), batches, 0,
                       *extra)
        outs.append((p, aux))
    for p, aux in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(p),
                                                     leaves(outs[0][0])))
        assert torch.equal(aux["losses"], outs[0][1]["losses"])
    with pytest.raises(ValueError, match="not both"):
        tsteps.make_fused_round_step(cfg, ccfg, device="cpu", codec="exact",
                                     compress="fused")


def test_one_row_per_pod_is_checked(pod):
    for r in pod["ranks"]:
        assert int(r["refused"]) == 3


def test_init_process_mesh_names_its_backend():
    with pytest.raises(ValueError, match="gloo"):
        tmesh.init_process_mesh(0, 1, "file:///nonexistent", "mpi", "cpu")
    with pytest.raises(ValueError, match="nccl"):
        tmesh.init_process_mesh(0, 1, "file:///nonexistent", "nccl", "cpu")


def test_intra_pod_axes_and_the_production_mesh_raise():
    """The intra-pod axes are ported (``tests/test_torch_intrapod.py``):
    what still raises is a production mesh over a group too small for it
    (no group here) and a spec the mesh cannot place."""
    with pytest.raises(ValueError, match="need a world of 256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="need a world of 512"):
        tmesh.make_production_mesh(multi_pod=True)
    specs = tspecs.param_specs(
        tavg.stack_participants({"w": torch.zeros(4, 8)}, 2), None,
        {"pod": 2, "data": 2, "model": 1}, participant=True)
    assert specs == {"w": ("pod", "data", "model")}
    assert tspecs.row_specs(specs) == {"w": (None, "data", "model")}

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    with pytest.raises(ValueError, match="axis order"):
        tspecs.placements((("data", "pod"), None), Mesh())
    with pytest.raises(ValueError, match="names axis 'x'"):
        tspecs.placements(("x",), Mesh())
    with pytest.raises(ValueError, match="twice"):
        tspecs.placements(("data", "data"), Mesh())
