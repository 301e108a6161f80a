"""The port's serving stack against the JAX package's: ``core/ensemble``,
``ModelBank`` (versioning, staleness, ensemble mode, persistence across
packages), ``ServeLoop`` (greedy tokens, hot swap without a new build,
the error cases; internlm2 over a KV cache, xlstm over its recurrent
state, jamba over its Mamba state, KV cache and MoE FFN) and
``launch/steps.make_prefill_step``.

Params are JAX-initialised and carried across with ``params_from_numpy``;
inputs come from numpy with a fixed seed. Greedy tokens must be equal;
log-probs agree at 1e-6 (linear model) or 1e-5 (LM).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import ensemble as jens
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.serving import ModelBank as JBank
from repro.serving import ServeLoop as JLoop
from repro_torch.checkpoint import io as tio
from repro_torch.core import ensemble as tens
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.serving import ModelBank, ServeLoop, serve_rounds_stats
from repro_torch.tree import tree_map


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tio.params_from_numpy(_np(tree), "cpu")


def lin_params(key=0, d=4, C=3):
    k = jax.random.PRNGKey(key)
    return {"w": jax.random.normal(k, (d, C)), "b": jnp.zeros((C,))}


def lin_apply(params, x):
    return x @ params["w"] + params["b"]


def cls_data(n=48, d=4, C=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, C, size=n).astype(np.int64)
    return x, y


def stacked(params_list):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *params_list)


def tiny_lm(window=0):
    return get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, window=window, segments=((("gqa:dense",), 1),))


# ---------------------------------------------------------------------------
# core/ensemble
# ---------------------------------------------------------------------------
def test_ensemble_logits_match_jax():
    stack = stacked([lin_params(k, 4, 5) for k in range(3)])
    x, y = cls_data(n=7, C=5)
    want = jens.ensemble_logits(lin_apply, stack, jnp.asarray(x))
    got = tens.ensemble_logits(lin_apply, _t(stack), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    acc = tens.ensemble_accuracy(lin_apply, _t(stack), torch.tensor(x),
                                 torch.tensor(y))
    assert float(acc) == pytest.approx(float(jens.ensemble_accuracy(
        lin_apply, stack, jnp.asarray(x), jnp.asarray(y))))


def test_ensemble_k1_reduces_to_single_model():
    p = _t(stacked([lin_params(0)]))
    x = torch.tensor(cls_data(n=16)[0])
    single = torch.log_softmax(lin_apply({"w": p["w"][0], "b": p["b"][0]},
                                         x), -1)
    torch.testing.assert_close(tens.ensemble_logits(lin_apply, p, x),
                               single, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# ModelBank
# ---------------------------------------------------------------------------
class _Log:
    def __init__(self, synced):
        self.synced = synced


class _FakeLearner:
    def shared_model(self, state):
        return {k: v[0] for k, v in state["params"].items()}


def _state(params_stack, round_i, synced):
    return {"params": params_stack, "round": round_i,
            "global_epoch": 2 * round_i, "log": [_Log(synced)]}


def test_bank_versioning_and_quiet_round_staleness():
    stack = _t(stacked([lin_params(0), lin_params(1)]))
    learner = _FakeLearner()
    bank = ModelBank(publish_on="synced")
    assert bank.version == 0 and bank.current() is None
    assert bank.staleness(3) >= 10 ** 6
    assert bank.publish_from(learner, _state(stack, 1, True)) is not None
    assert bank.version == 1 and bank.current().round == 1
    assert bank.current().global_epoch == 2
    torch.testing.assert_close(bank.current().params["w"], stack["w"][0])
    assert bank.publish_from(learner, _state(stack, 2, False)) is None
    assert bank.version == 1
    assert bank.staleness(2) == 1 and bank.staleness(4) == 3
    assert bank.publish_from(learner, _state(stack, 3, True)).version == 2
    assert bank.staleness(3) == 0
    always = ModelBank(publish_on="always")
    assert always.publish_from(learner, _state(stack, 1, False)) is not None
    assert always.version == 1 and always.current().synced is False


def test_bank_persists_and_reloads_what_it_serves(tmp_path):
    p = _t(lin_params(3))
    x = torch.tensor(cls_data(n=16)[0])
    bank = ModelBank(dir=str(tmp_path))
    bank.publish(p, round_i=5, global_epoch=10)
    served = bank.predict_logits(lin_apply, x)
    like = {k: torch.zeros_like(v) for k, v in p.items()}
    bank2 = ModelBank.load(str(tmp_path), like=like)
    assert bank2.version == 1 and bank2.current().round == 5
    assert torch.equal(bank2.predict_logits(lin_apply, x), served)


def test_bank_ensemble_mode_matches_jax():
    stack = stacked([lin_params(k) for k in range(3)])
    x, y = cls_data(n=32)
    bank = ModelBank(mode="ensemble", publish_on="always")
    bank.publish(_t(stack), round_i=1)
    lp = bank.predict_logits(lin_apply, torch.tensor(x))
    want = jens.ensemble_logits(lin_apply, stack, jnp.asarray(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), atol=1e-6)
    acc = bank.accuracy(lin_apply, torch.tensor(x), torch.tensor(y))
    assert float(acc) == pytest.approx(float(jens.ensemble_accuracy(
        lin_apply, stack, jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("mode", ["ensemble", "shared"])
def test_published_snapshot_survives_the_next_round(mode, engine):
    """A snapshot from ``publish_from`` is the bank's own: the engines
    train and mix the learner's tensors in place, and the round after the
    publication leaves the snapshot bit for bit unchanged, in both modes
    (an ensemble publication used to hand over the live stacked tree)."""
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core.colearn import CoLearner

    def loss(p, b):
        return torch.nn.functional.cross_entropy(lin_apply(p, b[0]),
                                                 b[1]), {}
    x, y = cls_data(n=48)
    batches = (torch.tensor(x).reshape(3, 2, 8, 4),
               torch.tensor(y).reshape(3, 2, 8))
    learner = CoLearner(CoLearnConfig(n_participants=3, T0=1, eta0=0.5,
                                      max_rounds=3),
                        loss, round_engine=engine, device="cpu")
    state = learner.init(_t(lin_params(0)))
    state = learner.run_round(state, lambda i, j: batches)
    bank = ModelBank(mode=mode)
    snap = bank.publish_from(learner, state)
    kept = {k: v.clone() for k, v in snap.params.items()}
    live = {k: v.clone() for k, v in state["params"].items()}
    state = learner.run_round(state, lambda i, j: batches)
    assert not torch.equal(state["params"]["w"], live["w"])  # it trained
    for k, v in snap.params.items():
        assert torch.equal(v, kept[k]), k
        assert all(v.data_ptr() != t.data_ptr()
                   for t in state["params"].values())
    assert bank.current() is snap


def test_bank_rejects_bad_modes(tmp_path):
    with pytest.raises(ValueError):
        ModelBank(mode="nope")
    with pytest.raises(ValueError):
        ModelBank(publish_on="sometimes")
    with pytest.raises(RuntimeError):
        ModelBank().predict_logits(lin_apply, torch.zeros((1, 4)))
    with pytest.raises(FileNotFoundError):
        ModelBank.load(str(tmp_path), like={})


@pytest.mark.parametrize("mode", ["shared", "ensemble"])
def test_bank_persisted_by_jax_serves_the_same_logprobs(tmp_path, mode):
    """The JAX ModelBank writes two versions; the port's ModelBank.load
    restores the newest and serves the JAX bank's log-probs at 1e-6."""
    jbank = JBank(mode=mode, publish_on="always", dir=str(tmp_path))
    make = ((lambda s: stacked([lin_params(s + k) for k in range(3)]))
            if mode == "ensemble" else lin_params)
    jbank.publish(make(0), round_i=1, global_epoch=2)
    jbank.publish(make(5), round_i=2, global_epoch=4, synced=False)
    x, _ = cls_data(n=16)
    want = jbank.predict_logits(lin_apply, jnp.asarray(x))
    like = _t(jax.tree.map(jnp.zeros_like, make(0)))
    bank = ModelBank.load(str(tmp_path), like=like)
    snap = bank.current()
    assert (snap.version, snap.round, snap.global_epoch, snap.synced,
            snap.mode) == (2, 2, 4, False, mode)
    got = bank.predict_logits(lin_apply, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_lm_bank_persisted_by_jax_serves_the_same_logprobs(tmp_path):
    """Same, for the tiny LM served through prefill (K5's path)."""
    cfg = tiny_lm()
    jp = jtr.init_params(jax.random.PRNGKey(4), cfg, jnp.float32)
    jbank = JBank(dir=str(tmp_path))
    jbank.publish(jp, round_i=1)
    x = np.random.default_rng(5).integers(0, 64, (2, 16)).astype(np.int32)
    want = jbank.predict_logits(
        lambda p, b: jtr.prefill(p, cfg, b, impl="pallas"),
        {"tokens": jnp.asarray(x)})
    bank = ModelBank.load(str(tmp_path), like=ttr.init_params(
        0, cfg, torch.float32, device="cpu"))
    got = bank.predict_logits(
        lambda p, b: ttr.prefill(p, cfg, b, impl="kernel"),
        {"tokens": torch.tensor(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# ServeLoop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 4])
def test_serveloop_tokens_equal_jax_and_swap_needs_no_build(window):
    cfg = tiny_lm(window)
    p0 = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p1 = jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jloop = JLoop(cfg, p0, batch=2, max_seq=12)
    loop = ServeLoop(cfg, _t(p0), batch=2, max_seq=12, device="cpu")
    assert loop.compile_count() == 1
    gen0, stats0 = loop.generate(torch.tensor(prompts), 4)
    jgen0, _ = jloop.generate(jnp.asarray(prompts), 4)
    assert gen0.shape == (2, 4)
    np.testing.assert_array_equal(gen0.numpy(), np.asarray(jgen0))
    assert stats0["version"] == 0 and stats0["tokens"] == 8

    # the loop's logits after the prompt are the prefill's, token by token
    logits, _ = loop.prefill(torch.tensor(prompts))
    torch.testing.assert_close(
        logits[:, 0], ttr.prefill(loop.params, cfg,
                                  {"tokens": torch.tensor(prompts)},
                                  impl="kernel"), rtol=1e-5, atol=1e-5)

    bank, jbank = ModelBank(), JBank()
    bank.publish(_t(p1), round_i=1)
    jbank.publish(p1, round_i=1)
    assert loop.poll(bank) is True and loop.version == 1
    assert loop.poll(bank) is False
    assert jloop.poll(jbank) is True
    gen1, stats1 = loop.generate(torch.tensor(prompts), 4)
    jgen1, _ = jloop.generate(jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(gen1.numpy(), np.asarray(jgen1))
    assert not torch.equal(gen1, gen0)
    assert loop.compile_count() == 1 and stats1["compile_count"] == 1
    assert stats1["version"] == 1
    assert loop.tokens_served == 16 and loop.batches_served == 2
    summary = serve_rounds_stats([stats0, stats1])
    assert summary["rounds_served"] == 2 and summary["total_tokens"] == 16
    assert summary["versions"] == [0, 1]


def test_xlstm_serveloop_tokens_equal_jax_and_swap_needs_no_build():
    """xlstm-1.3b's smoke config through the loop: the recurrent states
    are the cache. Greedy tokens equal the JAX loop's before and after a
    ModelBank swap, with one decode-step build; the loop's last-prompt
    logits are ``prefill(impl="kernel")``'s at 1e-5."""
    cfg = get_smoke_config("xlstm-1.3b")
    p0 = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p1 = jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jloop = JLoop(cfg, p0, batch=2, max_seq=12)
    loop = ServeLoop(cfg, _t(p0), batch=2, max_seq=12, device="cpu")
    gen0, _ = loop.generate(torch.tensor(prompts), 4)
    jgen0, _ = jloop.generate(jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(gen0.numpy(), np.asarray(jgen0))
    logits, _ = loop.prefill(torch.tensor(prompts))
    torch.testing.assert_close(
        logits[:, 0], ttr.prefill(loop.params, cfg,
                                  {"tokens": torch.tensor(prompts)},
                                  impl="kernel"), rtol=1e-5, atol=1e-5)
    bank, jbank = ModelBank(), JBank()
    bank.publish(_t(p1), round_i=1)
    jbank.publish(p1, round_i=1)
    assert loop.poll(bank) and jloop.poll(jbank)
    gen1, stats1 = loop.generate(torch.tensor(prompts), 4)
    jgen1, _ = jloop.generate(jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(gen1.numpy(), np.asarray(jgen1))
    assert not torch.equal(gen1, gen0)
    assert loop.compile_count() == 1 and stats1["version"] == 1


def test_xlstm_make_prefill_step_matches_jax():
    cfg = get_smoke_config("xlstm-1.3b")
    jp = jtr.init_params(jax.random.PRNGKey(7), cfg, jnp.float32)
    x = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                          (2, 24)).astype(np.int32)
    want = jsteps.make_prefill_step(cfg, impl="pallas")(
        jp, {"tokens": jnp.asarray(x)})
    got = tsteps.make_prefill_step(cfg, impl="kernel")(
        _t(jp), {"tokens": torch.tensor(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_jamba_serveloop_tokens_equal_jax_and_swap_needs_no_build():
    """jamba-v0.1-52b's smoke config through the loop at its own capacity
    factor: greedy tokens equal the JAX loop's before and after a
    ModelBank swap, with one decode-step build. At a drop-free capacity
    factor (capacity dropping depends on how many tokens a call sees) the
    loop's last-prompt logits are ``prefill(impl="kernel")``'s at 1e-5."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    p0 = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p1 = jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jloop = JLoop(cfg, p0, batch=2, max_seq=12)
    loop = ServeLoop(cfg, _t(p0), batch=2, max_seq=12, device="cpu")
    gen0, _ = loop.generate(torch.tensor(prompts), 4)
    jgen0, _ = jloop.generate(jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(gen0.numpy(), np.asarray(jgen0))
    free = cfg.with_(capacity_factor=float(cfg.n_experts))
    logits, _ = ServeLoop(free, loop.params, batch=2, max_seq=12,
                          device="cpu").prefill(torch.tensor(prompts))
    torch.testing.assert_close(
        logits[:, 0], ttr.prefill(loop.params, free,
                                  {"tokens": torch.tensor(prompts)},
                                  impl="kernel"), rtol=1e-5, atol=1e-5)
    bank, jbank = ModelBank(), JBank()
    bank.publish(_t(p1), round_i=1)
    jbank.publish(p1, round_i=1)
    assert loop.poll(bank) and jloop.poll(jbank)
    gen1, stats1 = loop.generate(torch.tensor(prompts), 4)
    jgen1, _ = jloop.generate(jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(gen1.numpy(), np.asarray(jgen1))
    assert not torch.equal(gen1, gen0)
    assert loop.compile_count() == 1 and stats1["version"] == 1


def test_jamba_make_prefill_step_matches_jax():
    cfg = get_smoke_config("jamba-v0.1-52b")
    jp = jtr.init_params(jax.random.PRNGKey(8), cfg, jnp.float32)
    x = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                          (2, 24)).astype(np.int32)
    want = jsteps.make_prefill_step(cfg, impl="pallas")(
        jp, {"tokens": jnp.asarray(x)})
    got = tsteps.make_prefill_step(cfg, impl="kernel")(
        _t(jp), {"tokens": torch.tensor(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_serveloop_rejects_what_it_cannot_serve():
    cfg = tiny_lm()
    p = _t(jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32))
    loop = ServeLoop(cfg, p, batch=2, max_seq=12, device="cpu")
    prompts = torch.zeros((2, 4), dtype=torch.int64)
    bad = dict(p, extra=torch.zeros((3,)))
    with pytest.raises(ValueError, match="treedef/shapes"):
        loop.swap(bad, 9)
    half = dict(p, embed={"table": p["embed"]["table"].to(torch.bfloat16)})
    meta = tree_map(lambda t: t.to("meta"), p)
    for wrong in (half, meta):            # a dtype, a device
        with pytest.raises(ValueError, match="treedef/shapes"):
            loop.swap(wrong, 9)
    assert loop.version == 0
    with pytest.raises(ValueError, match="overruns"):
        loop.generate(prompts, 9)
    with pytest.raises(ValueError, match="batch"):
        loop.generate(torch.zeros((3, 4), dtype=torch.int64), 2)
    ens = ModelBank(mode="ensemble")
    ens.publish(p, round_i=1)
    with pytest.raises(ValueError, match="ensemble"):
        loop.poll(ens)
    with pytest.raises(ValueError, match="must lie on"):
        ServeLoop(cfg, meta, batch=2, max_seq=12, device="cpu")


def test_serveloop_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_lm()
    p = ttr.init_params(0, cfg, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(cfg, p, batch=2, max_seq=12)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.init_cache(cfg, 2, 12, torch.float32)


# ---------------------------------------------------------------------------
# launch/steps
# ---------------------------------------------------------------------------
def test_make_prefill_step_matches_jax():
    cfg = get_smoke_config("internlm2-1.8b")
    jp = jtr.init_params(jax.random.PRNGKey(6), cfg, jnp.float32)
    x = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                          (2, 24)).astype(np.int32)
    want = jsteps.make_prefill_step(cfg, impl="pallas")(
        jp, {"tokens": jnp.asarray(x)})
    got = tsteps.make_prefill_step(cfg, impl="kernel")(
        _t(jp), {"tokens": torch.tensor(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
