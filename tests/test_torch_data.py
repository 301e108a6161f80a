"""Ragged shards and shard-size weighting in the port against the JAX
package, on the CPU: the masked epoch of both round engines (single-shot
and chunked fused rounds), the masked step as an exact identity carry,
the learner's mask checks, the shard sizes wired into
``PartialParticipation``, and the heterogeneous scenario end to end.

Shaped after ``tests/test_data.py``'s engine half (its partitioner and
pipeline half is the port's own copy of ``data/``, which
``tests/test_torch_isolation.py`` and the CLI tests reach). Tolerances:
trajectories within 1e-5, a masked step bit-exact to no step, comm bytes
exact; under the quantizing codec the shared model within one wire code
step, as ``tests/test_torch_colearn.py`` holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import flatbuf as jfb
from repro.core.colearn import CoLearner as JCoLearner
from repro.kernels import ref as jref
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.core.schedule import clr_lr
from repro_torch.tree import leaves

TOL = {"rtol": 1e-5, "atol": 1e-7}


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


def engine_of(mod, engine, chunk=32):
    return mod.PythonEngine() if engine == "python" else mod.FusedEngine(
        chunk)


def tree_diff(j, t):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jax.tree.leaves(j), leaves(t)))


def t_run(cfg, rounds, b, engine, chunk=32, **kw):
    learner = TCoLearner(cfg, tloss, round_engine=engine_of(tapi, engine,
                                                            chunk),
                         device="cpu", **kw)
    state = learner.init(params_from_numpy(params_np(), "cpu"))
    data = tuple(map(torch.as_tensor, b))
    for _ in range(rounds):
        state = learner.run_round(state, lambda i, j: data)
    return learner, state


def j_run(cfg, rounds, b, **kw):
    learner = JCoLearner(cfg, jloss, **kw)
    state = learner.init(jax.tree.map(jnp.asarray, params_np()))
    data = tuple(map(jnp.asarray, b))
    for _ in range(rounds):
        state = learner.run_round(state, lambda i, j: data)
    return learner, state


def logs_close(a, b):
    assert [x.T for x in a["log"]] == [x.T for x in b["log"]]
    assert ([x.comm_bytes for x in a["log"]]
            == [x.comm_bytes for x in b["log"]])
    for x, y in zip(a["log"], b["log"]):
        np.testing.assert_allclose(y.local_losses, x.local_losses, **TOL)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_masked_equals_unmasked_on_equal_shards(engine):
    """An all-True mask reproduces the unmasked trajectory."""
    K, nb = 3, 4
    b = batches_np(K, nb, 8)
    cfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.05, epsilon=0.5,
                        max_rounds=2)
    _, su = t_run(cfg, 2, b, engine)
    _, sm = t_run(cfg, 2, b, engine, batch_mask=np.ones((K, nb), bool))
    logs_close(su, sm)
    assert max(float((x - y).abs().max()) for x, y in zip(
        leaves(su["params"]), leaves(sm["params"]))) <= 1e-6


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adamw"])
def test_masked_step_is_an_exact_identity_carry(optimizer):
    """Participant 1 owns one real batch of three: after the masked epoch
    its params and every optimizer leaf (AdamW's step count too) equal an
    unmasked epoch over that one batch, bit for bit, and its epoch loss is
    that batch's loss. Participant 0 (all real) equals the unmasked
    epoch."""
    K, nb = 2, 3
    b = tuple(map(torch.as_tensor, batches_np(K, nb, 8)))
    mask = np.array([[True, True, True], [True, False, False]])
    cfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, max_rounds=1)
    masked = TCoLearner(cfg, tloss, optimizer_name=optimizer,
                        batch_mask=mask, device="cpu")
    plain = TCoLearner(cfg, tloss, optimizer_name=optimizer, device="cpu")
    lr = clr_lr(0.05, 0.25, 0, 1)
    sm = masked.init(params_from_numpy(params_np(), "cpu"))
    _, _, loss_m = masked._epoch(sm["params"], sm["opt"], b, lr,
                                 masked.batch_mask)
    for k, n in ((0, nb), (1, 1)):
        sp = plain.init(params_from_numpy(params_np(), "cpu"))
        _, _, loss_p = plain._epoch(sp["params"], sp["opt"],
                                    tuple(t[:, :n] for t in b), lr)
        for got, want in ((sm["params"], sp["params"]),
                          (sm["opt"], sp["opt"])):
            assert all(torch.equal(x[k], y[k])
                       for x, y in zip(leaves(got), leaves(want)))
        assert torch.equal(loss_m[k], loss_p[k])
    if optimizer == "adamw":
        assert sm["opt"]["t"].tolist() == [3, 1]


@pytest.mark.parametrize("engine,chunk", [("python", 32), ("fused", 32),
                                          ("fused", 1)])
def test_ragged_rounds_match_jax(engine, chunk):
    """Three rounds of T0 = 2 on a (3, 4) mask with momentum, against the
    JAX python engine; chunk = 1 splits every round into chunk graphs."""
    K, nb = 3, 4
    b = batches_np(K, nb, 8)
    mask = np.array([[True] * 4, [True] * 2 + [False] * 2,
                     [True] * 3 + [False]])
    cfg = CoLearnConfig(n_participants=K, T0=2, eta0=0.05, epsilon=0.5,
                        max_rounds=3)
    _, js = j_run(cfg, 3, b, batch_mask=mask, optimizer_name="momentum")
    tl, ts = t_run(cfg, 3, b, engine, chunk, batch_mask=mask,
                   optimizer_name="momentum")
    logs_close(js, ts)
    assert tree_diff(js["params"], ts["params"]) <= 1e-5
    assert tl.batch_mask.dtype == torch.bool
    if engine == "fused":
        # a round graph per T; chunks of one epoch share one chunk graph
        assert (tl._fused_round.captures, tl._fused_epochs.captures) == (
            (len({x.T for x in ts["log"]}), 0) if chunk == 32 else (0, 1))


def test_learner_rejects_bad_mask():
    cfg = CoLearnConfig(n_participants=2, T0=1, max_rounds=1)
    with pytest.raises(ValueError, match="batch_mask"):
        TCoLearner(cfg, tloss, batch_mask=np.ones((3, 2), bool),
                   device="cpu")
    with pytest.raises(ValueError, match="batch_mask"):
        TCoLearner(cfg, tloss, batch_mask=np.ones(2, bool), device="cpu")
    with pytest.raises(ValueError, match="zero valid"):
        TCoLearner(cfg, tloss, batch_mask=np.array([[True, True],
                                                    [False, False]]),
                   device="cpu")
    with pytest.raises(ValueError, match="masked epoch"):
        TCoLearner(cfg, tloss, batch_mask=np.ones((2, 2), bool),
                   device="cpu")._epoch({}, {}, (), 0.1)


def test_partial_participation_takes_the_shard_sizes():
    """A weightless partial aggregator gets the shard sizes as its FedAvg
    weights, as in the JAX package; explicit weights stay."""
    cfg = CoLearnConfig(n_participants=3, T0=1, max_rounds=1)
    for mod, CL, loss, kw in ((japi, JCoLearner, jloss, {}),
                              (tapi, TCoLearner, tloss, {"device": "cpu"})):
        learner = CL(cfg, loss, aggregator=mod.PartialParticipation(m=2),
                     shard_sizes=(10, 20, 30), **kw)
        assert learner.aggregator.weights == (10, 20, 30)
        learner = CL(cfg, loss, aggregator=mod.PartialParticipation(
            m=2, weights=(1.0, 1.0, 1.0)), shard_sizes=(10, 20, 30), **kw)
        assert learner.aggregator.weights == (1.0, 1.0, 1.0)
        with pytest.raises(ValueError, match="shard_sizes"):
            CL(cfg, loss, shard_sizes=(10, 20), **kw)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_heterogeneous_smoke_transformer_matches_jax(engine):
    """The slice's data path as a whole: the 1-layer smoke transformer on
    quantity-skewed shards of 3, 2 and 1 batches (a (3, 3) mask), partial
    participation (m = 2) over the fused codec with the shard sizes wired
    in, two rounds against the JAX fused engine."""
    from repro.configs import get_smoke_config
    from repro.models import transformer as jtr
    from repro_torch.launch.train import build_data
    from repro_torch.models import transformer as ttr
    cfg = get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, segments=((("gqa:dense",), 1),))
    K = 3
    data = build_data(cfg, K, 4, 16, 24, partition="sizes",
                      sizes=[12, 8, 4])
    assert data.sizes == (12, 8, 4) and data.ragged
    mask = data.batch_mask
    assert mask.sum(1).tolist() == [3, 2, 1]
    p_np = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0),
                                                    cfg, jnp.float32))
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=0.5,
                         max_rounds=2)
    runs = []
    for mod, CL, loss, conv, eng, kw in (
            (japi, JCoLearner, lambda p, b: jtr.loss_fn(
                p, cfg, {"tokens": b[0], "labels": b[1]}),
             lambda t: jax.tree.map(jnp.asarray, t), "fused", {}),
            (tapi, TCoLearner, lambda p, b: ttr.loss_fn(
                p, cfg, {"tokens": b[0], "labels": b[1]}),
             lambda t: params_from_numpy(t, "cpu"), engine,
             {"device": "cpu"})):
        learner = CL(ccfg, loss, codec=mod.get_codec("fused"),
                     aggregator=mod.PartialParticipation(m=2),
                     round_engine=eng, shard_sizes=data.sizes,
                     batch_mask=mask, **kw)
        state = learner.init(conv(p_np))
        for _ in range(2):
            state = learner.run_round(state, lambda i, j: tuple(
                map(conv, data.epoch_batches(i, j))))
        runs.append((learner, state))
    (jl, js), (tl, ts) = runs
    assert tl.aggregator.weights == (12, 8, 4)
    logs_close(js, ts)
    for x in ts["log"]:
        assert all(np.isfinite(x.local_losses)) and x.comm_bytes > 0
    # the shared model within one wire code step of a row: a ~1e-7
    # difference in training can move a value across a rounding boundary
    buf = jfb.flatten(js["params"], jfb.make_layout(js["params"]))
    scale = jref.quantize_blockwise_ref(buf)[1]
    live = jnp.abs(buf.reshape(-1, 256)).max(axis=1) > 0
    quantum = float(jnp.max(jnp.where(live, scale, 0.0)))
    assert 0 < quantum < 0.01
    assert tree_diff(js["prev_avg"], ts["prev_avg"]) <= quantum
