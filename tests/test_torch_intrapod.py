"""The intra-pod mesh of the port: DTensor placements from
``sharding/specs.py`` on the reference SCRIPT's (pod 2, data 2, model 2)
mesh (``tests/test_sharding.py``), on the CPU.

One module fixture starts eight ranks over gloo: ``subprocess`` workers
(one torch thread each, a ``file://`` rendezvous in the test's tmp dir)
that import no JAX. Each places the same numpy inputs with
``specs.distribute`` (a rank's trees live inside its pod: the pod's
block, split over ``data`` and ``model``), runs every step of the
reference's SCRIPT items 1-5 and 4b-4f once and writes what it gathered
inside its pod to an npz. The parent holds each result against the
port's unsharded path on the same inputs, and the local steps against
the JAX package's unsharded steps, at 1e-5 (rtol = atol); the codecs'
K1 payloads, recorded inside the mesh aggregate, against the unsharded
rows' bit for bit.
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
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api as tapi
from repro_torch.core import averaging as tavg
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves, leaves_with_path, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
K, WORLD, NDEC = 2, 8, 8
TOL = {"rtol": 1e-5, "atol": 1e-5}
ARCH = "internlm2-1.8b"

WORKER = r"""
import sys
import numpy as np
import torch

rank, world, d, NDEC = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        int(sys.argv[4]))
torch.set_num_threads(1)
from repro_torch.checkpoint.io import restore_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api, averaging
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import transformer as tr
from repro_torch.sharding import specs as sp
from repro_torch.tree import leaves, leaves_with_path

K = 2
M.init_process_mesh(rank, world, f"file://{d}/rdv", "gloo", "cpu")
mesh = M.make_sim_mesh((K, 2, 2), ("pod", "data", "model"), "cpu")
cfg = get_smoke_config("internlm2-1.8b")
like = tr.init_params(0, cfg, torch.float32, device="cpu")
params = restore_pytree(f"{d}/params.npz", like)
stacked = restore_pytree(f"{d}/stacked.npz",
                         averaging.stack_participants(like, K))
corr = restore_pytree(f"{d}/corr.npz", averaging.stack_participants(like, K))
inp = dict(np.load(f"{d}/inputs.npz"))
W = {n[2:]: torch.as_tensor(v) for n, v in inp.items() if n.startswith("W_")}
out = {}


def put(name, tree):
    for path, t in leaves_with_path(sp.gather(tree)):
        out[f"{name}/{path}"] = t.detach().numpy().copy()


# every K1 call's payload, as the aggregates make it
payloads = []
_quantize = ops.quantize_blockwise


def spy(x, **kw):
    q, s, shape = _quantize(x, **kw)
    payloads.append((q.clone(), s.clone()))
    return q, s, shape


ops.quantize_blockwise = spy


def record(name):
    out[f"{name}_n"] = np.array(len(payloads))
    for i, (q, s) in enumerate(payloads):
        out[f"{name}_q{i}"], out[f"{name}_s{i}"] = q.numpy(), s.numpy()
    payloads.clear()


# 0) a tuple entry shards one dim major to minor
x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
for name, spec in (("order_dm", (("data", "model"), None)),
                   ("order_pd", (("pod", "data"), None))):
    out[name] = sp.distribute({"x": x}, {"x": spec}, mesh)["x"] \
        .to_local().numpy()

# 1) the vanilla train step on the 3-axis mesh (and in two microbatches)
dparams = sp.distribute(params, sp.param_specs(params, cfg, mesh), mesh)
batch = {k: torch.as_tensor(inp[k]) for k in ("tokens", "labels")}
dbatch = sp.distribute(batch, sp.batch_specs(cfg, mesh, "train"), mesh)
for mb in (1, 2):
    new, loss = steps.make_train_step(cfg, lr=0.01, microbatch=mb,
                                      mesh=mesh)(dparams, dbatch)
    put(f"train{mb}", new)
    out[f"train{mb}_loss"] = loss.numpy()
    out[f"train{mb}_placed"] = np.array(all(
        a.placements == b.placements
        for a, b in zip(leaves(new), leaves(dparams))))

# 2) the co-learning step on the pod's row
pspecs_k = sp.param_specs(stacked, cfg, mesh, participant=True)


def row(tree):
    return sp.distribute(tree, pspecs_k, mesh)


cbatch = sp.distribute({k: torch.as_tensor(inp["c" + k])
                        for k in ("tokens", "labels")},
                       sp.batch_specs(cfg, mesh, "train", participant=True),
                       mesh)
new_rows, losses = steps.make_colearn_train_step(cfg, lr=0.01)(row(stacked),
                                                              cbatch)
put("colearn", new_rows)
out["colearn_loss"] = losses.numpy()

# 3) Eq. 2 as the explicit all-reduce over pod, shard by shard
put("avg", averaging.make_average_shard_map(mesh)(row(stacked)))

# 4b / 4c / 4f) the codecs on the pod's gathered rows
for name, codec in (("flat8", api.FlatFusedInt8()),
                    ("leaf8", api.LeafwiseInt8()),
                    ("flatN8", api.FlatFusedIntN(bits=8)),
                    ("leafN8", api.LeafwiseIntN(bits=8)),
                    ("flat4", api.FlatFusedIntN(bits=4))):
    put(name, api.FullAverage().make_aggregate_fn(codec, mesh=mesh)(
        row(stacked)))
    record(name)
ef = api.FlatFusedIntN(bits=4, error_feedback=True)
mixed, res = api.FullAverage().make_aggregate_fn(ef, mesh=mesh)(
    row(stacked), None, ef.init_state(row(stacked)))
put("ef4", mixed)
out["ef4_res"] = res.numpy()
record("ef4")

# 4d / 4e / 4f) weighted psums, permutes and D2 on the local shards
for name, agg in (("partial", api.PartialParticipation(m=2, seed=0)),
                  ("weighted", api.FullAverage(weights=(3.0, 1.0))),
                  ("ring", api.RingGossip()),
                  ("hypercube", api.GraphGossip("hypercube")),
                  ("grid2d", api.GraphGossip("grid2d"))):
    fn = agg.make_aggregate_fn(api.ExactF32(), mesh=mesh)
    put(name, fn(row(stacked), W[name]))
    out[f"{name}_dense"] = np.array(fn.dense_fallback)
mixed, c2 = api.D2Gossip("hypercube").make_aggregate_fn(
    api.ExactF32(), mesh=mesh)(row(stacked), W["hypercube"], row(corr))
put("d2", mixed)
put("d2corr", c2)
put("wflat", api.FlatFusedInt8().make_fused_mean(mesh=mesh, weighted=True)(
    row(stacked), W["weighted"][0]))
record("wflat")

# 4 / 4e / 4f) the fused round step on the 3-axis mesh
ccfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.01, max_rounds=1)
rspec = (None, "pod", None, "data", None)
rbatch = sp.distribute({k: torch.as_tensor(inp["r" + k])
                        for k in ("tokens", "labels")},
                       {"tokens": rspec, "labels": rspec}, mesh)
p = mesh.get_local_rank("pod")
for name, kw in (("round", {}),
                 ("round8", {"codec": "fused"}),
                 ("roundmask", {"aggregator": api.FullAverage(
                     weights=(3.0, 1.0)), "masked": True}),
                 ("roundef", {"codec": "fused", "codec_bits": 4,
                              "error_feedback": True})):
    rf = steps.make_fused_round_step(cfg, ccfg, mesh=mesh,
                                     param_specs=pspecs_k, **kw)
    args = [row(stacked), ()]
    if kw.get("error_feedback"):
        args.append(api.FlatFusedIntN(bits=4, error_feedback=True)
                    .init_state(row(stacked)))
    args.append(rbatch)
    if kw.get("masked"):
        args.append(torch.as_tensor(inp["mask"][p:p + 1]))
    args.append(0)
    if kw.get("masked"):
        args.append(W["weighted"])
    prm, _, aux = rf(*args)
    put(name, prm)
    put(name + "_avg", aux["new_avg"])
    out[name + "_losses"] = aux["losses"].numpy()
    out[name + "_rel"] = aux["rel"].numpy()
    if "residual" in aux:
        out[name + "_res"] = aux["residual"].numpy()
    payloads.clear()

# 5) prefill, and decode on the cache placed by cache_specs
out["prefill"] = sp.gather(steps.make_prefill_step(cfg)(dparams,
                                                         dbatch)).numpy()
cache = tr.init_cache(cfg, 8, 16, torch.float32, device="cpu")
dcache = sp.distribute(cache, sp.cache_specs(cache, mesh, 8), mesh)
serve = steps.make_serve_step(cfg)
for i in range(NDEC):
    tok = sp.distribute({"tokens": torch.as_tensor(inp["dtokens"][:, i:i + 1])},
                        sp.batch_specs(cfg, mesh, "decode"), mesh)["tokens"]
    logits, dcache = serve(dparams, dcache, tok, torch.tensor(i))
    out[f"decode{i}"] = sp.gather(logits).numpy()
put("cache", dcache)
np.savez(f"{d}/out{rank}.npz", **out)
"""

# the reference's device placement of P(("data", "model")) and
# P(("pod", "data")) over the (2, 2, 2) mesh, rank-major devices
PLACEMENT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
out = {}
for name, spec in (("order_dm", P(("data", "model"))),
                   ("order_pd", P(("pod", "data")))):
    idx = NamedSharding(mesh, spec).devices_indices_map((8, 3))
    out[name] = [[idx[dv][0].start or 0, idx[dv][0].stop or 8]
                 for dv in jax.devices()[:8]]
print("RESULT " + json.dumps(out))
"""


def _paths(tree):
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in leaves(tree)):
        return [(p, t.detach().numpy()) for p, t in leaves_with_path(tree)]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(v)) for path, v in flat]


def _save(path, tree):
    np.savez(path, **dict(_paths(tree)))


def _clone(tree):
    return tree_map(torch.clone, tree)


def _row(tree, k):
    return tree_map(lambda t: t[k:k + 1].clone(), tree)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("intrapod")
    jcfg = jget_smoke_config(ARCH)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    jstacked = jax.tree.map(
        lambda t: jnp.asarray(np.asarray(t)[None] + 0.02 * rng.standard_normal(
            (K, *t.shape)).astype(np.float32)), jparams)
    jcorr = jax.tree.map(lambda t: jnp.asarray(
        0.01 * rng.standard_normal(t.shape).astype(np.float32)), jstacked)
    for name, tree in (("params", jparams), ("stacked", jstacked),
                       ("corr", jcorr)):
        _save(d / f"{name}.npz", tree)
    V = jcfg.vocab_size
    Ws = {"partial": tapi.PartialParticipation(m=2, seed=0)
          .mixing_matrix(0, K),
          "weighted": tapi.FullAverage(weights=(3.0, 1.0))
          .mixing_matrix(0, K),
          "ring": tapi.RingGossip().mixing_matrix(0, K),
          "hypercube": tapi.GraphGossip("hypercube").mixing_matrix(0, K),
          "grid2d": tapi.GraphGossip("grid2d").mixing_matrix(0, K)}
    inp = {
        "tokens": rng.integers(0, V, (8, 16), np.int32),
        "labels": rng.integers(0, V, (8, 16), np.int32),
        "ctokens": rng.integers(0, V, (K, 4, 16), np.int32),
        "clabels": rng.integers(0, V, (K, 4, 16), np.int32),
        "rtokens": rng.integers(0, V, (2, K, 1, 4, 16), np.int32),
        "rlabels": rng.integers(0, V, (2, K, 1, 4, 16), np.int32),
        "mask": np.array([[True], [False]]),
        "dtokens": rng.integers(0, V, (8, NDEC), np.int32),
        **{f"W_{n}": np.asarray(w, np.float32) for n, w in Ws.items()}}
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(k), str(WORLD), str(d),
         str(NDEC)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(WORLD)]
    placement = subprocess.Popen(
        [sys.executable, "-c", PLACEMENT], env=dict(env, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = _reference(jcfg, jparams, jstacked, jcorr, inp)
        errs = []
        for p in procs + [placement]:
            so, err = p.communicate(timeout=400)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs + [placement]:
            if p.poll() is None:
                p.kill()
    assert not errs, errs[0]
    line = [s for s in so.splitlines() if s.startswith("RESULT ")][-1]
    import json
    ranks = [dict(np.load(d / f"out{k}.npz")) for k in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "inp": inp,
            "placement": json.loads(line[len("RESULT "):])}


def _spied(fn, *args):
    """``fn(*args)`` and the K1 payloads it made."""
    got = []
    real = tops.quantize_blockwise

    def spy(x, **kw):
        q, s, shape = real(x, **kw)
        got.append((q.clone(), s.clone()))
        return q, s, shape
    tops.quantize_blockwise = spy
    try:
        return fn(*args), got
    finally:
        tops.quantize_blockwise = real


def _reference(jcfg, jparams, jstacked, jcorr, inp):
    """The JAX package's and the port's unsharded results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _reference_1t(jcfg, jparams, jstacked, jcorr, inp)
    finally:
        torch.set_num_threads(threads)


def _reference_1t(jcfg, jparams, jstacked, jcorr, inp):
    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    stacked = params_from_numpy(jax.tree.map(np.asarray, jstacked), "cpu")
    corr = params_from_numpy(jax.tree.map(np.asarray, jcorr), "cpu")
    W = {n[2:]: torch.as_tensor(v) for n, v in inp.items()
         if n.startswith("W_")}
    T = {k: torch.as_tensor(v) for k, v in inp.items()}
    out = {"jax": {}}
    batch = {"tokens": T["tokens"], "labels": T["labels"]}
    jbatch = {"tokens": jnp.asarray(inp["tokens"]),
              "labels": jnp.asarray(inp["labels"])}
    for mb in (1, 2):
        out[f"train{mb}"] = tsteps.make_train_step(
            cfg, lr=0.01, microbatch=mb)(params, batch)
        out["jax"][f"train{mb}"] = jax.jit(jsteps.make_train_step(
            jcfg, lr=0.01, microbatch=mb))(jparams, jbatch)
    cb = {"tokens": T["ctokens"], "labels": T["clabels"]}
    out["colearn"] = tsteps.make_colearn_train_step(cfg, lr=0.01)(stacked,
                                                                  cb)
    out["jax"]["colearn"] = jax.jit(jax.vmap(jsteps.make_train_step(
        jcfg, lr=0.01)))(jstacked, {"tokens": jnp.asarray(inp["ctokens"]),
                                    "labels": jnp.asarray(inp["clabels"])})
    out["avg"] = tavg.average_pjit(_clone(stacked))

    # the codecs as the unsharded pod path runs them: each pod roundtrips
    # its own row, then the mean
    def rowwise(codec, ef=False):
        rts, pays, res = [], [], []
        for k in range(K):
            r = _row(stacked, k)
            if ef:
                (rt, e), got = _spied(codec.roundtrip_ef, r,
                                      codec.init_state(r))
                res.append(e)
            else:
                rt, got = _spied(codec.roundtrip, r)
            rts.append(rt)
            pays.append(got)
        mean = tavg.average_pjit(tree_map(lambda *xs: torch.cat(xs), *rts))
        return mean, pays, res
    for name, codec in (("flat8", tapi.FlatFusedInt8()),
                        ("leaf8", tapi.LeafwiseInt8()),
                        ("flatN8", tapi.FlatFusedIntN(bits=8)),
                        ("leafN8", tapi.LeafwiseIntN(bits=8)),
                        ("flat4", tapi.FlatFusedIntN(bits=4))):
        out[name], out[name + "_pay"], _ = rowwise(codec)
    ef = tapi.FlatFusedIntN(bits=4, error_feedback=True)
    out["ef4"], out["ef4_pay"], out["ef4_res"] = rowwise(ef, ef=True)
    for name, agg in (("partial", tapi.PartialParticipation(m=2, seed=0)),
                      ("weighted", tapi.FullAverage(weights=(3.0, 1.0))),
                      ("ring", tapi.RingGossip()),
                      ("hypercube", tapi.GraphGossip("hypercube")),
                      ("grid2d", tapi.GraphGossip("grid2d"))):
        out[name] = agg._make_host_aggregate_fn(tapi.ExactF32())(
            _clone(stacked), W[name])
    out["d2"], out["d2corr"] = tapi.D2Gossip("hypercube") \
        ._make_host_aggregate_fn(tapi.ExactF32())(
            _clone(stacked), W["hypercube"], _clone(corr))
    wrow = W["weighted"][0]
    out["wflat"], out["wflat_pay"] = _spied(
        lambda s: tapi.FlatFusedInt8().make_fused_mean(weighted=True)(
            s, wrow), _clone(stacked))
    # the fused rounds on the simulation path
    ccfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.01, max_rounds=1)
    rb = {"tokens": T["rtokens"], "labels": T["rlabels"]}
    for name, kw in (("round", {}),
                     ("round8", {"codec": "fused"}),
                     ("roundmask", {"aggregator": tapi.FullAverage(
                         weights=(3.0, 1.0)), "masked": True}),
                     ("roundef", {"codec": "fused", "codec_bits": 4,
                                  "error_feedback": True})):
        rf = tsteps.make_fused_round_step(cfg, ccfg, device="cpu", **kw)
        args = [_clone(stacked), ()]
        if kw.get("error_feedback"):
            args.append(tapi.FlatFusedIntN(bits=4, error_feedback=True)
                        .init_state(stacked))
        args.append(rb)
        if kw.get("masked"):
            args.append(T["mask"])
        args.append(0)
        if kw.get("masked"):
            args.append(W["weighted"])
        out[name] = rf(*args)
    # serving, unsharded: the port's and the JAX package's
    out["prefill"] = tsteps.make_prefill_step(cfg)(params, batch)
    out["jax"]["prefill"] = jtr.prefill(jparams, jcfg, jbatch)
    cache = ttr.init_cache(cfg, 8, 16, torch.float32, device="cpu")
    jcache = jtr.init_cache(jcfg, 8, 16, jnp.float32)
    serve = tsteps.make_serve_step(cfg)
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    for i in range(NDEC):
        tok = T["dtokens"][:, i:i + 1]
        out[f"decode{i}"], cache = serve(params, cache, tok, torch.tensor(i))
        out["jax"][f"decode{i}"], jcache = jserve(
            jparams, jcache, jnp.asarray(inp["dtokens"][:, i:i + 1]),
            jnp.int32(i))
    out["cache"] = cache
    return out


def _tree(rank_out, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


def _pod_ranks(p):
    return range(p * WORLD // K, (p + 1) * WORLD // K)


def _check_tree(got, want, pod=None):
    """``got`` (a rank's gathered tree) against ``want`` (a whole tree; its
    row ``pod`` when given)."""
    want = dict(_paths(want))
    assert got.keys() == want.keys()
    for p, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[p], w if pod is None
                                   else w[pod:pod + 1], err_msg=p, **TOL)


def test_tuple_entry_shards_major_to_minor_as_the_reference(mesh):
    """A tuple entry over two mesh axes: DTensor's order of two Shard(0)
    inside a pod (data, model) and the pods' blocks (pod, data) put the
    same rows on each rank as the reference's PartitionSpec does."""
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for name in ("order_dm", "order_pd"):
        for k, r in enumerate(mesh["ranks"]):
            lo, hi = mesh["placement"][name][k]
            np.testing.assert_array_equal(r[name], x[lo:hi])
        assert len({r[name].tobytes() for r in mesh["ranks"]}) == 4


@pytest.mark.parametrize("mb", [1, 2])
def test_vanilla_train_step_on_the_mesh(mesh, mb):
    """SCRIPT item 1: params over data and model, the batch over pod and
    data; the pods' gradients averaged. Against the port's and the JAX
    package's unsharded step; every rank's params equal, their
    placements kept."""
    jnew, jloss = mesh["ref"]["jax"][f"train{mb}"]
    new, loss = mesh["ref"][f"train{mb}"]
    for r in mesh["ranks"]:
        got = _tree(r, f"train{mb}")
        _check_tree(got, new)
        _check_tree(got, jnew)
        np.testing.assert_allclose(r[f"train{mb}_loss"], loss.numpy(), **TOL)
        np.testing.assert_allclose(r[f"train{mb}_loss"], np.asarray(jloss),
                                   **TOL)
        assert bool(r[f"train{mb}_placed"])


def test_colearn_rows_on_the_mesh_stay_apart(mesh):
    """SCRIPT item 2: each pod steps its own row inside the pod; against
    the unsharded rows of the port and of the JAX package's vmapped step;
    the two pods' replicas differ."""
    new, losses = mesh["ref"]["colearn"]
    jnew, jlosses = mesh["ref"]["jax"]["colearn"]
    for p in range(K):
        for k in _pod_ranks(p):
            got = _tree(mesh["ranks"][k], "colearn")
            _check_tree(got, new, pod=p)
            _check_tree(got, jnew, pod=p)
            np.testing.assert_allclose(mesh["ranks"][k]["colearn_loss"],
                                       losses.numpy()[p:p + 1], **TOL)
            np.testing.assert_allclose(mesh["ranks"][k]["colearn_loss"],
                                       np.asarray(jlosses)[p:p + 1], **TOL)
    a, b = (_tree(mesh["ranks"][k], "colearn") for k in (0, WORLD - 1))
    assert max(float(np.abs(a[n] - b[n]).max()) for n in a) > 0


ROWS_EQUAL = ["avg", "flat8", "leaf8", "flatN8", "leafN8", "flat4", "ef4",
              "partial", "weighted", "wflat"]


@pytest.mark.parametrize("name", ROWS_EQUAL + ["ring", "hypercube",
                                               "grid2d", "d2", "d2corr"])
def test_aggregates_on_the_mesh_match_the_unsharded_path(mesh, name):
    """SCRIPT items 3, 4b-4f: Eq. 2 over the local shards (exact) or the
    pod's gathered rows (codecs) equals the unsharded path's; where every
    row takes the same mean, both pods hold it bit for bit."""
    for p in range(K):
        for k in _pod_ranks(p):
            _check_tree(_tree(mesh["ranks"][k], name), mesh["ref"][name],
                        pod=p)
    if name in ROWS_EQUAL:
        trees = [_tree(r, name) for r in mesh["ranks"]]
        assert all(np.array_equal(trees[0][n], t[n])
                   for t in trees[1:] for n in trees[0])
    if name in ("partial", "weighted", "ring", "hypercube", "grid2d"):
        assert not any(bool(r[f"{name}_dense"]) for r in mesh["ranks"])


@pytest.mark.parametrize("name", ["flat8", "leaf8", "flatN8", "leafN8",
                                  "flat4", "ef4", "wflat"])
def test_codec_payloads_bit_exact(mesh, name):
    """The K1 payloads the mesh aggregate makes from the pod's gathered
    row are the unsharded row's, code for code and scale for scale."""
    pays = mesh["ref"][name + "_pay"]
    for p in range(K):
        want = pays[p] if name != "wflat" else pays
        for k in _pod_ranks(p):
            r = mesh["ranks"][k]
            if name == "wflat":
                # the simulation path quantises the (K, N_pad) buffer in
                # one call: this pod's rows of it
                (q, s), = want
                n = q.shape[0] // K
                want_p = [(q[p * n:(p + 1) * n], s[p * n:(p + 1) * n])]
            else:
                want_p = want
            assert int(r[f"{name}_n"]) == len(want_p) > 0
            for i, (q, s) in enumerate(want_p):
                np.testing.assert_array_equal(r[f"{name}_q{i}"], q.numpy())
                np.testing.assert_array_equal(r[f"{name}_s{i}"], s.numpy())


def test_error_feedback_residual_stays_in_its_pod(mesh):
    for p in range(K):
        for k in _pod_ranks(p):
            np.testing.assert_allclose(mesh["ranks"][k]["ef4_res"],
                                       mesh["ref"]["ef4_res"][p].numpy(),
                                       **TOL)
    assert np.abs(mesh["ranks"][0]["ef4_res"]).max() > 0


@pytest.mark.parametrize("name", ["round", "round8", "roundmask",
                                  "roundef"])
def test_fused_round_on_the_mesh_matches_the_simulation(mesh, name):
    """SCRIPT items 4, 4e, 4f: one fused round on the 3-axis mesh (the
    exact, int8 flat, weighted masked and int4 error-feedback codecs)
    against the simulation path's; the pods' slots equal after Eq. 2."""
    prm, _, aux = mesh["ref"][name]
    for p in range(K):
        for k in _pod_ranks(p):
            r = mesh["ranks"][k]
            _check_tree(_tree(r, name), prm, pod=p)
            _check_tree(_tree(r, name + "_avg"), aux["new_avg"])
            np.testing.assert_allclose(r[name + "_losses"],
                                       aux["losses"].numpy(), **TOL)
            np.testing.assert_allclose(r[name + "_rel"],
                                       aux["rel"].numpy(), **TOL)
            if "residual" in aux:
                np.testing.assert_allclose(
                    r[name + "_res"], aux["residual"][p:p + 1].numpy(),
                    **TOL)
    a, b = (_tree(mesh["ranks"][k], name) for k in (0, WORLD - 1))
    assert all(np.array_equal(a[n], b[n]) for n in a)


def test_prefill_and_decode_on_cache_specs(mesh):
    """SCRIPT item 5: the prefill and eight decode steps with the cache
    placed by ``cache_specs`` (the batch over pod and data); each pod's
    rows against the port's and the JAX package's unsharded steps, and
    the cache they leave."""
    B = 8 // K
    for p in range(K):
        rows = slice(p * B, (p + 1) * B)
        for k in _pod_ranks(p):
            r = mesh["ranks"][k]
            np.testing.assert_allclose(
                r["prefill"], mesh["ref"]["prefill"].numpy()[rows], **TOL)
            np.testing.assert_allclose(
                r["prefill"], np.asarray(mesh["ref"]["jax"]["prefill"])[rows],
                **TOL)
            for i in range(NDEC):
                np.testing.assert_allclose(
                    r[f"decode{i}"],
                    mesh["ref"][f"decode{i}"].numpy()[rows], **TOL)
                np.testing.assert_allclose(
                    r[f"decode{i}"],
                    np.asarray(mesh["ref"]["jax"][f"decode{i}"])[rows],
                    **TOL)
            got = _tree(r, "cache")
            for n, w in _paths(mesh["ref"]["cache"]):
                np.testing.assert_allclose(got[n], w[:, rows], err_msg=n,
                                           **TOL)
