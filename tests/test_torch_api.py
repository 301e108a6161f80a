"""The round-strategy API of the port against the JAX package, on the CPU:
the flat codec's standalone encode / decode / error-feedback roundtrip,
``CustomFn``, ``PartialParticipation`` (the sampling, the aggregate, the
bill, both engines), ``CoLearner.from_flags`` and ``param_bytes``, and
``optim.clip_by_global_norm``.

Shaped after ``tests/test_api.py``. Tolerances: the flat codec's
payloads bit-exact to the JAX oracle (``impl="ref"``: the port's plain
versions are held to the oracle, not to the Pallas kernels, whose payload
length differs), its 8/4-bit scales too, the 1-bit scale (a mean, summed
in another order) at rtol 1e-6 as ``tests/test_torch_kernels.py`` holds
it; the mixing matrices exact; aggregates within 1e-6;
trajectories within 1e-5; comm bytes exact.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core.colearn import CoLearner as JCoLearner
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.optim import optimizers as topt
from repro_torch.tree import leaves

TOL = {"rtol": 1e-5, "atol": 1e-6}


def jloss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def tloss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def params_np(key=0, d=4):
    w = jax.random.normal(jax.random.PRNGKey(key), (d, 1))
    return {"w": np.asarray(w), "b": np.zeros((1,), np.float32)}


def batches_np(K, n_batches, B, d=4, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (K, n_batches, B, d))
    return np.asarray(x), np.asarray(x @ jnp.arange(1.0, d + 1)[:, None])


def mixed_tree(K=3, seed=7):
    """Stacked tree spanning block-aligned, odd-size and sub-block leaves
    (numpy; tests/test_api.py's)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {"w": np.asarray(jax.random.normal(ks[0], (K, 2, 256))),
            "odd": np.asarray(jax.random.normal(ks[1], (K, 300))),
            "tiny": np.asarray(jax.random.normal(ks[2], (K, 5))),
            "vec": np.asarray(jax.random.normal(ks[3], (K,)))}


def jtree(t):
    return jax.tree.map(jnp.asarray, t)


def ttree(t):
    return params_from_numpy(t, "cpu")


def tree_diff(j, t):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jax.tree.leaves(j), leaves(t)))


def tree_equal(j, t):
    return all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(jax.tree.leaves(j), leaves(t)))


# --- the flat codec's standalone path, CustomFn ------------------------------
@pytest.mark.parametrize("bits", [8, 4, 1])
def test_flat_codec_standalone_matches_jax_oracle(bits):
    """``encode`` (one quantize over the (K, N_pad) buffer), ``decode``
    and ``roundtrip_ef`` give the JAX oracle's payloads, tree and new
    residual bit for bit."""
    stacked = mixed_tree()
    jc = japi.FlatFusedIntN(bits=bits, error_feedback=True, impl="ref")
    tc = tapi.FlatFusedIntN(bits=bits, error_feedback=True)
    jw, tw = jc.encode(jtree(stacked)), tc.encode(ttree(stacked))
    assert (tw[0].n_pad, tw[0].offsets) == (jw[0].n_pad, jw[0].offsets)
    assert tuple(tw[3]) == tuple(jw[3])
    assert np.array_equal(tw[1].numpy(), np.asarray(jw[1]))
    # the same payload decodes to the same tree
    same = (tw[0], torch.tensor(np.asarray(jw[1])),
            torch.tensor(np.asarray(jw[2])), tw[3])
    assert tree_equal(jc.decode(jw), tc.decode(same))
    rng = np.random.default_rng(bits)
    res = (rng.standard_normal((3, tw[0].n_pad)) * 0.01).astype(np.float32)
    jrt, jres = jc.roundtrip_ef(jtree(stacked), jnp.asarray(res))
    trt, tres = tc.roundtrip_ef(ttree(stacked), torch.tensor(res))
    if bits == 1:
        # the 1-bit scale is a mean: its summation order differs (one ulp)
        np.testing.assert_allclose(tw[2].numpy(), np.asarray(jw[2]),
                                   rtol=1e-6)
        assert tree_diff(jrt, trt) <= 1e-6
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(tw[2].numpy(), np.asarray(jw[2]))
        assert tree_equal(jc.roundtrip(jtree(stacked)),
                          tc.roundtrip(ttree(stacked)))
        assert tree_equal(jrt, trt)
        assert np.array_equal(tres.numpy(), np.asarray(jres))
    assert tc.wire_bytes(ttree(stacked)) == jc.wire_bytes(jtree(stacked))


def test_custom_fn_codec_matches_jax():
    stacked = mixed_tree()
    half_j = japi.CustomFn(lambda t: jax.tree.map(lambda x: x * 0.5, t))
    half_t = tapi.CustomFn(lambda t: {k: v * 0.5 for k, v in t.items()})
    assert half_t.name == "custom" and not half_t.stateful
    assert tree_equal(half_j.roundtrip(jtree(stacked)),
                      half_t.roundtrip(ttree(stacked)))
    assert (half_t.wire_bytes(ttree(stacked))
            == half_j.wire_bytes(jtree(stacked))
            == tapi.participant_bytes(ttree(stacked)))


# --- PartialParticipation ---------------------------------------------------------
@pytest.mark.parametrize("m,K,weights,seed", [
    (2, 4, None, 0), (2, 4, (1.0, 2.0, 3.0, 4.0), 3), (1, 3, (0.0, 1.0, 1.0), 0),
    (3, 5, (5, 0, 2, 7, 1), 11), (4, 4, None, 2)])
def test_partial_mixing_matrix_matches_jax(m, K, weights, seed):
    """The same numpy draw: the same sampled columns and weights, every
    row identical, never a zero-weight participant."""
    jagg = japi.PartialParticipation(m=m, weights=weights, seed=seed)
    tagg = tapi.PartialParticipation(m=m, weights=weights, seed=seed)
    for i in range(12):
        W = tagg.mixing_matrix(i, K)
        assert W.dtype == np.float32 and W.shape == (K, K)
        np.testing.assert_array_equal(W, jagg.mixing_matrix(i, K))
        assert np.count_nonzero(W[0]) == m
        np.testing.assert_allclose(W.sum(1), 1.0, rtol=1e-6)
        if weights is not None:
            assert (W[:, np.asarray(weights) == 0] == 0).all()
    assert tapi.get_aggregator("partial").name == "partial"


def test_partial_participation_rejects_what_jax_rejects():
    for agg, K, match in (
            (dict(m=9), 4, "1 <= m <= K"),
            (dict(m=2, weights=(0.0, 0.0, 1.0)), 3, "positive weight"),
            (dict(m=1, weights=(-1.0, 1.0, 1.0)), 3, "finite"),
            (dict(m=1, weights=(1.0, 1.0)), 3, "length")):
        for mod in (japi, tapi):
            with pytest.raises(ValueError, match=match):
                mod.PartialParticipation(**agg).mixing_matrix(0, K)


CODECS = {"exact": lambda m: m.ExactF32(),
          "fused": lambda m: m.get_codec("fused"),
          "fused-int4-ef": lambda m: m.get_codec("fused", bits=4,
                                                 error_feedback=True),
          "leafwise": lambda m: m.get_codec("leafwise")}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_partial_aggregate_and_bill_match_jax(codec):
    """The host aggregate (the codec's roundtrip, then the sampled rows'
    weighted mean into every row) and the bill ``ceil(m·up/K) + raw``;
    an unsampled row does not reach the result of a per-row codec."""
    K = 4
    stacked = mixed_tree(K=K)
    jagg = japi.PartialParticipation(m=2, seed=3)
    tagg = tapi.PartialParticipation(m=2, seed=3)
    W = tagg.mixing_matrix(0, K)
    jc, tc = CODECS[codec](japi), CODECS[codec](tapi)
    jfn, tfn = jagg.make_aggregate_fn(jc), tagg.make_aggregate_fn(tc)

    def call(fn, c, tree, W):
        if c.stateful:
            return fn(tree, W, c.init_state(tree))
        return fn(tree, W), None
    jout, jres = call(jfn, jc, jtree(stacked), jnp.asarray(W))
    tout, tres = call(tfn, tc, ttree(stacked), torch.tensor(W))
    assert tree_diff(jout, tout) <= 1e-6
    if tres is not None:
        assert float(np.abs(np.asarray(jres) - tres.numpy()).max()) <= 1e-6
    for t in leaves(tout):
        assert all(torch.equal(t[0], t[k]) for k in range(1, K))
    if codec != "leafwise":
        # (the leafwise codec's blocks run across the K rows of a leaf, so
        # there an unsampled row moves the sampled rows' scales)
        unsampled = int(np.nonzero(W[0] == 0)[0][0])
        moved = {k: v.copy() for k, v in stacked.items()}
        for v in moved.values():
            v[unsampled] += 100.0
        tout2, _ = call(tfn, tc, ttree(moved), torch.tensor(W))
        assert all(torch.equal(a, b) for a, b in zip(leaves(tout),
                                                     leaves(tout2)))
    bill = tagg.comm_bytes(tc, ttree(stacked), 0)
    assert bill == jagg.comm_bytes(jc, jtree(stacked), 0)
    assert bill == (math.ceil(2 * tc.wire_bytes(ttree(stacked)) / K)
                    + tapi.participant_bytes(ttree(stacked)))
    assert tagg.static_comm and tapi.FullAverage().static_comm


@pytest.mark.parametrize("engine,chunk", [("python", 32), ("fused", 32),
                                          ("fused", 1)])
def test_partial_participation_rounds_match_jax(engine, chunk):
    """Flat codec x partial participation (m = 2 of 3), three rounds of
    T0 = 2 with the ε doubling, against the JAX python engine: the same
    draws every round, the trajectory within 1e-5 and the bill exact."""
    K, m, d = 3, 2, 256
    cfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.05, epsilon=0.5,
                        max_rounds=3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (K, 3, 8, d)))
    w_true = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                          (d, 1))) / np.sqrt(d)
    b = (x, x @ w_true)
    runs = {}
    for mod, CL, loss, conv, eng in (
            (japi, JCoLearner, jloss, jtree, japi.PythonEngine()),
            (tapi, TCoLearner, tloss, ttree,
             tapi.PythonEngine() if engine == "python"
             else tapi.FusedEngine(chunk))):
        kw = {"device": "cpu"} if CL is TCoLearner else {}
        learner = CL(cfg, loss, codec=mod.FlatFusedInt8(),
                     aggregator=mod.PartialParticipation(m=m),
                     round_engine=eng, **kw)
        state = learner.init(conv(params_np(d=d)))
        data = conv(b)
        for _ in range(3):
            state = learner.run_round(state, lambda i, j: data)
        runs[mod] = (learner, state)
    (_, js), (tl, ts) = runs[japi], runs[tapi]
    wire = tl.codec.wire_bytes(ts["params"])
    for x_, y_ in zip(js["log"], ts["log"]):
        assert (x_.T, x_.comm_bytes) == (y_.T, y_.comm_bytes)
        assert y_.comm_bytes == math.ceil(m * wire / K) + tl.param_bytes(ts)
        np.testing.assert_allclose(y_.local_losses, x_.local_losses, **TOL)
    assert tree_diff(js["params"], ts["params"]) <= 1e-5


@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("static", [True, False])
def test_round_dependent_bill_follows_static_comm(static, engine):
    """A user aggregator whose bill grows with the round: priced once (the
    first round's bill on every round) while it says ``static_comm``, every
    round when it does not, as the JAX package's learner prices it."""
    def billing(mod):
        class Billing(mod.FullAverage):
            static_comm = static

            def comm_bytes(self, codec, stacked, round_index, live=None):
                return 1000 + round_index
        return Billing()

    cfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.05, epsilon=0.5,
                        max_rounds=3)
    b = batches_np(2, 2, 4)
    bills = {}
    for mod, CL, loss, conv, eng in (
            (japi, JCoLearner, jloss, jtree, japi.PythonEngine()),
            (tapi, TCoLearner, tloss, ttree,
             tapi.PythonEngine() if engine == "python"
             else tapi.FusedEngine())):
        kw = {"device": "cpu"} if CL is TCoLearner else {}
        learner = CL(cfg, loss, aggregator=billing(mod), round_engine=eng,
                     **kw)
        state = learner.init(conv(params_np()))
        data = conv(b)
        for _ in range(3):
            state = learner.run_round(state, lambda i, j: data)
        bills[mod] = [r.comm_bytes for r in state["log"]]
    assert bills[tapi] == bills[japi] == (
        [1000] * 3 if static else [1000, 1001, 1002])


# --- from_flags, param_bytes -----------------------------------------------------
@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("compress", [None, "leafwise", "fused", "fn"])
def test_from_flags_matches_explicit_objects(engine, compress):
    """The legacy flags build the same learner as the objects (1e-6) and
    run the JAX package's ``from_flags`` rounds (1e-5)."""
    cfg = CoLearnConfig(n_participants=3, T0=2, eta0=0.05, epsilon=0.5,
                        max_rounds=3)
    d = 8
    b = batches_np(3, 2, 8, d=d)

    def half(mod):
        if mod is japi:
            return lambda t: jax.tree.map(lambda x: x * 0.5, t)
        return lambda t: {k: v * 0.5 for k, v in t.items()}

    def flags(mod):
        if compress == "fn":
            return {"compress_fn": half(mod)}
        return {"compress": compress}

    codec = {None: lambda m: m.ExactF32(),
             "leafwise": lambda m: m.LeafwiseInt8(),
             "fused": lambda m: m.FlatFusedInt8(),
             "fn": lambda m: m.CustomFn(half(m))}[compress]
    learners = {
        "jax": JCoLearner.from_flags(cfg, jloss, engine=engine,
                                     **flags(japi)),
        "flags": TCoLearner.from_flags(cfg, tloss, engine=engine,
                                       device="cpu", **flags(tapi)),
        "objects": TCoLearner(cfg, tloss, codec=codec(tapi),
                              aggregator=tapi.FullAverage(),
                              round_engine=(tapi.FusedEngine()
                                            if engine == "fused"
                                            else tapi.PythonEngine()),
                              device="cpu")}
    assert (type(learners["flags"].codec).__name__
            == type(learners["jax"].codec).__name__)
    out = {}
    for label, learner in learners.items():
        conv = jtree if label == "jax" else ttree
        state = learner.init(conv(params_np(d=d)))
        data = conv(b)
        for _ in range(3):
            state = learner.run_round(state, lambda i, j: data)
        out[label] = state
    for label, tol in (("objects", 1e-6), ("jax", 1e-5)):
        ref = out[label]
        for lr, lf in zip(ref["log"], out["flags"]["log"]):
            assert (lr.T, lr.comm_bytes) == (lf.T, lf.comm_bytes)
            np.testing.assert_allclose(lf.local_losses, lr.local_losses,
                                       rtol=tol)
    assert tree_diff(out["jax"]["params"], out["flags"]["params"]) <= 1e-5
    assert (learners["flags"].param_bytes(out["flags"])
            == learners["jax"].param_bytes(out["jax"]) == 4 * (d + 1))


def test_from_flags_rejects_bad_flags():
    cfg = CoLearnConfig(n_participants=2)
    for kw in ({"engine": "jit"}, {"compress": "int8"},
               {"compress": "fused", "compress_fn": lambda t: t}):
        with pytest.raises(ValueError):
            TCoLearner.from_flags(cfg, tloss, device="cpu", **kw)


# --- optim.clip_by_global_norm ----------------------------------------------------
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    np.testing.assert_allclose(float(topt.global_norm(ttree(g))),
                               float(jopt.global_norm(jtree(g))), rtol=1e-6)
    got = topt.clip_by_global_norm(ttree(g), max_norm)
    want = jopt.clip_by_global_norm(jtree(g), max_norm)
    assert tree_diff(want, got) <= 1e-6
    if max_norm > 100:                        # under the cap: unchanged
        assert tree_equal(jtree(g), got)
    else:
        np.testing.assert_allclose(float(topt.global_norm(got)), max_norm,
                                   rtol=1e-5)
    bf = topt.clip_by_global_norm({"x": torch.ones(3, dtype=torch.bfloat16)},
                                  0.5)
    assert bf["x"].dtype == torch.bfloat16
