"""Algorithm 1 end to end: the port's ``CoLearner`` against the JAX one.

Shaped after ``tests/test_engine.py``'s smoke-transformer case: K=3,
T0=1, 3 rounds, the python engine on both sides, the same JAX-initialised
params and the same numpy batches. The exact codec holds the shared model
and every round-log field to <= 1e-5.

The quantizing codecs (fused at 8 bits, leafwise, fused int4 with error
feedback) keep the same log checks, but the parameters are held to one
wire quantum — the largest row scale of the JAX side's flat buffer over K
— because a ~1e-7 difference in training can move a value across a .5
rounding boundary and flip one code by one step.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import flatbuf as jfb
from repro.core.colearn import CoLearner as JCoLearner
from repro.data.partition import partition_arrays
from repro.data.pipeline import ParticipantData
from repro.data.synthetic import lm_examples
from repro.kernels import ref as jref
from repro.models import transformer as jtr
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves

K, ROUNDS = 3, 3
TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, segments=((("gqa:dense",), 1),))
    x, y = lm_examples(0, 24, 16, cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K, 0), batch_size=4)
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, data, jax.tree.map(np.asarray, params)


def _run(setup, codec, eps=1e-6, weights=None):
    cfg, data, params_np = setup
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=eps,
                         max_rounds=ROUNDS)

    def jloss(p, b):
        return jtr.loss_fn(p, cfg, {"tokens": b[0], "labels": b[1]})

    def tloss(p, b):
        return ttr.loss_fn(p, cfg, {"tokens": b[0], "labels": b[1]})

    spec, kw = codec
    jl = JCoLearner(ccfg, jloss, codec=japi.get_codec(spec, **kw),
                    aggregator=japi.FullAverage(weights=weights),
                    round_engine="python")
    tl = TCoLearner(ccfg, tloss, codec=tapi.get_codec(spec, **kw),
                    aggregator=tapi.FullAverage(weights=weights),
                    device="cpu")
    js = jl.init(jax.tree.map(jnp.asarray, params_np))
    ts = tl.init(params_from_numpy(params_np, "cpu"))
    for _ in range(ROUNDS):
        js = jl.run_round(js, lambda i, j: tuple(
            map(jnp.asarray, data.epoch_batches(i, j))))
        ts = tl.run_round(ts, lambda i, j: tuple(
            map(torch.as_tensor, data.epoch_batches(i, j))))
    return js, ts, jl, tl


def _check_logs(js, ts):
    assert len(js["log"]) == len(ts["log"]) == ROUNDS
    for a, b in zip(js["log"], ts["log"]):
        assert (a.round, a.T, a.comm_bytes) == (b.round, b.T, b.comm_bytes)
        np.testing.assert_allclose(b.local_losses, a.local_losses, **TOL)
        np.testing.assert_allclose([b.lr_first, b.lr_last],
                                   [a.lr_first, a.lr_last], **TOL)
        if np.isinf(a.rel_change):
            assert np.isinf(b.rel_change)
        else:
            np.testing.assert_allclose(b.rel_change, a.rel_change, **TOL)
    assert js["ctrl"].T == ts["ctrl"].T
    assert js["global_epoch"] == ts["global_epoch"]
    # both trained
    assert np.mean(ts["log"][-1].local_losses) < np.mean(
        ts["log"][0].local_losses)


def _max_diff(ta, ja):
    return max(float(np.abs(t.numpy() - np.asarray(j)).max())
               for t, j in zip(leaves(ta), jax.tree.leaves(ja)))


def _quantum(stacked, bits):
    """Largest per-row wire scale of the JAX side's flat buffer over K
    (rows of zero padding, whose scale is 1.0 by definition, excluded)."""
    buf = jfb.flatten(stacked, jfb.make_layout(stacked))
    _, scale, _ = jref.quantize_blockwise_ref(buf, bits=bits)
    live = jnp.abs(buf.reshape(-1, 256)).max(axis=1) > 0
    return float(jnp.max(jnp.where(live, scale, 0.0))) / K


def test_exact_codec_matches_jax(setup):
    js, ts, jl, tl = _run(setup, ("exact", {}))
    _check_logs(js, ts)
    assert _max_diff(tl.shared_model(ts), jl.shared_model(js)) <= 1e-5


@pytest.mark.parametrize("codec", [("fused", {"bits": 8}),
                                   ("leafwise", {"bits": 8})])
def test_quantized_codecs_match_jax(setup, codec):
    js, ts, jl, tl = _run(setup, codec)
    _check_logs(js, ts)
    q = _quantum(js["params"], 8)
    assert 0 < q < 0.01
    assert _max_diff(ts["params"], js["params"]) <= q


def test_weighted_fused_average_matches_jax(setup):
    """FedAvg example-count weights: the flat buffer through K1/K2 and one
    weighted sum instead of K3."""
    js, ts, jl, tl = _run(setup, ("fused", {"bits": 8}), weights=(3, 1, 2))
    _check_logs(js, ts)
    assert _max_diff(ts["params"], js["params"]) <= _quantum(js["params"], 8)


def test_fused_int4_error_feedback_matches_jax(setup):
    js, ts, jl, tl = _run(setup, ("fused", {"bits": 4,
                                            "error_feedback": True}))
    _check_logs(js, ts)
    q = _quantum(js["params"], 4)
    assert _max_diff(ts["params"], js["params"]) <= q
    res_t, res_j = ts["residual"].numpy(), np.asarray(js["residual"])
    assert res_t.shape == res_j.shape
    assert np.abs(res_t - res_j).max() <= q
    assert np.abs(res_t).max() > 0          # the residual is live


def test_ile_doubles_t_like_jax(setup):
    """A loose ε: round 1's relative change falls under it, so both sides
    double T and round 2 runs two local epochs."""
    js, ts, jl, tl = _run(setup, ("exact", {}), eps=0.5)
    _check_logs(js, ts)
    assert [b.T for b in ts["log"]] == [1, 1, 2]
    assert ts["ctrl"].T == 4
    assert _max_diff(tl.shared_model(ts), jl.shared_model(js)) <= 1e-5


def test_restart_participant_resets_row(setup):
    cfg, data, params_np = setup
    ccfg = CoLearnConfig(n_participants=K, T0=1, max_rounds=1)
    tl = TCoLearner(ccfg, lambda p, b: ttr.loss_fn(
        p, cfg, {"tokens": b[0], "labels": b[1]}),
        codec=tapi.get_codec("fused", bits=4, error_feedback=True),
        device="cpu")
    ts = tl.init(params_from_numpy(params_np, "cpu"))
    ts = tl.run_round(ts, lambda i, j: tuple(
        map(torch.as_tensor, data.epoch_batches(i, j))))
    for t in leaves(ts["params"]):
        t[1].add_(1.0)
    tl.restart_participant(ts, 1)
    for t, s in zip(leaves(ts["params"]), leaves(ts["prev_avg"])):
        assert torch.equal(t[1], s)
    assert (ts["residual"][1] == 0).all()
    assert (ts["residual"][0] != 0).any()


def _big_tensors():
    return [o for o in gc.get_objects()
            if type(o) is torch.Tensor and o.numel() >= 4096]


def test_round_frees_its_tensors_without_the_collector(setup):
    """No reference cycle keeps a round's tensors alive: at full width on
    the card every leaked temporary is a model-sized buffer (a recursive
    closure in the tree walker once held ~13 model copies)."""
    cfg, data, params_np = setup
    gc.collect()
    gc.disable()
    try:
        before = len(_big_tensors())
        tl = TCoLearner(CoLearnConfig(n_participants=K, T0=1, max_rounds=1),
                        lambda p, b: ttr.loss_fn(
                            p, cfg, {"tokens": b[0], "labels": b[1]}),
                        codec=tapi.get_codec("fused", bits=4,
                                             error_feedback=True),
                        device="cpu")
        ts = tl.init(params_from_numpy(params_np, "cpu"))
        ts = tl.run_round(ts, lambda i, j: tuple(
            map(torch.as_tensor, data.epoch_batches(i, j))))
        del ts
        assert len(_big_tensors()) == before
    finally:
        gc.enable()
