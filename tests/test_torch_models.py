"""The PyTorch port's transformer (gqa:dense) against the JAX package.

Parameters are JAX-initialised and carried across with
``repro_torch.checkpoint.io.params_from_numpy``; inputs come from numpy
with a fixed seed. Forward values, the loss and every gradient leaf agree
at <= 1e-5 (f32 on both sides; sums run in other orders). The serving
half — ``prefill`` through either attention path and the KV-cache
``decode_step`` (full cache and sliding-window ring buffer) — agrees with
the JAX package's at 1e-5 as well, against ``prefill(impl="pallas")``
(the Pallas kernel in interpret mode on the CPU).

xlstm-1.3b's smoke config (one ``mlstm:-`` and one ``slstm:-`` layer):
the bf16 tree keeps the JAX keys, shapes and dtypes (``w_if``, ``b_if``,
``r`` and ``b`` stay f32, through the bridge and the npz format too); the
loss, ``prefill(impl="kernel")`` against JAX ``prefill(impl="pallas")``
(the mLSTM kernel in interpret mode) and ``decode_step`` over the
recurrent states, which the port updates in place, agree at 1e-5.

jamba-v0.1-52b's smoke config (one ``mamba:moe`` and one ``gqa:dense``
layer): the Mamba mixer (prefill and in-place decode) and the MoE FFN
(grouped sort-based dispatch, at a capacity factor that drops tokens and
at drop-free ones, with and without a shared expert, y and aux loss), the
bf16 tree (``A_log``, ``D`` and the router stay f32) and its npz round
trip, the loss with the aux term, ``prefill`` against JAX ``"pallas"``
(K5 and K6 in interpret mode) and ``decode_step`` agree at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch.checkpoint import io as tio
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves, leaves_with_path

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(n_layers=2):
    return get_smoke_config("internlm2-1.8b").with_(
        n_layers=n_layers, segments=((("gqa:dense",), n_layers),))


def _tokens(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y[0, :3] = -1                         # ignored positions
    return x, y


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_rmsnorm_rope_ffn_xent():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    _close(tlayers.rmsnorm_apply({"g": torch.tensor(g)}, torch.tensor(x)),
           jlayers.rmsnorm_apply({"g": jnp.asarray(g)}, jnp.asarray(x)))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    _close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    ffn = _np(jlayers.ffn_init(jax.random.PRNGKey(0), 32, 64, jnp.float32))
    h = x[:, :, 0]
    _close(tlayers.ffn_apply(tio.params_from_numpy(ffn, "cpu"),
                             torch.tensor(h)),
           jlayers.ffn_apply(jax.tree.map(jnp.asarray, ffn), jnp.asarray(h)))
    logits = rng.standard_normal((2, 8, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    labels[1, 2:5] = -1
    _close(tlayers.softmax_xent(torch.tensor(logits), torch.tensor(labels)),
           jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("chunk", [1024, 8])
def test_chunked_attention(chunk):
    """Single block and 4x4 blocks of the online softmax (S=32)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 32, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    kw = dict(n_kv_heads=4, chunk_q=chunk, chunk_kv=chunk)
    _close(tattn.chunked_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), **kw),
           jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))


def test_params_tree_matches_jax_layout():
    """Same keys, nesting, order and shapes as the JAX tree."""
    cfg = _cfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = ttr.init_params(0, cfg, torch.float32, device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in leaves_with_path(tp)] == jpaths
    assert [tuple(t.shape) for t in leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert ttr.count_params(tp) == jtr.count_params(jp)


def test_loss_and_every_gradient_match_jax():
    cfg = _cfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x, y = _tokens(cfg)
    jbatch = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    (jl, _), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jp, cfg, jbatch)
    tp = tio.params_from_numpy(_np(jp), "cpu")
    tparams = [t.requires_grad_() for t in leaves(tp)]
    tl, _ = ttr.loss_fn(tp, cfg, {"tokens": torch.tensor(x),
                                  "labels": torch.tensor(y)})
    _close(tl, jl)
    grads = torch.autograd.grad(tl, tparams)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        _close(g, want)


def test_npz_checkpoint_crosses_packages(tmp_path):
    """JAX writes, the port reads (and back), bf16 via the ::bf16 view."""
    from repro.checkpoint import io as jio
    cfg = _cfg(n_layers=1)
    jp = jtr.init_params(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    jio.save_pytree(str(tmp_path / "j.npz"), jp)
    like = ttr.init_params(1, cfg, torch.bfloat16, device="cpu")
    tp = tio.restore_pytree(str(tmp_path / "j.npz"), like)
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(j).view(np.int16))
    tio.save_pytree(str(tmp_path / "t.npz"), tp)
    back = jio.restore_pytree(str(tmp_path / "t.npz"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      np.asarray(b).view(np.int16))
    # the bridge copies: updating the tensor leaves the numpy source alone
    src = _np(jtr.init_params(jax.random.PRNGKey(4), cfg, jnp.float32))
    t32 = tio.params_from_numpy(src, "cpu")
    before = src["embed"]["table"].copy()
    t32["embed"]["table"].add_(1.0)
    np.testing.assert_array_equal(src["embed"]["table"], before)
    back32 = tio.params_to_numpy(t32)
    np.testing.assert_array_equal(back32["embed"]["table"], before + 1.0)


# ---------------------------------------------------------------------------
# serving: prefill and the KV-cache decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_prefill_matches_jax_pallas(impl):
    """Last-position logits of a 2-layer GQA LM (H=8, KV=4)."""
    cfg = _cfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x, _ = _tokens(cfg, B=2, S=32)
    want = jtr.prefill(jp, cfg, {"tokens": jnp.asarray(x)}, impl="pallas")
    tp = tio.params_from_numpy(_np(jp), "cpu")
    got = ttr.prefill(tp, cfg, {"tokens": torch.tensor(x)}, impl=impl)
    assert tuple(got.shape) == (2, cfg.vocab_size)
    _close(got, want)


def test_forward_impls_agree_and_hidden_is_returned():
    cfg = _cfg()
    tp = tio.params_from_numpy(
        _np(jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)), "cpu")
    x, _ = _tokens(cfg, B=2, S=16)
    batch = {"tokens": torch.tensor(x)}
    lr, _ = ttr.forward(tp, cfg, batch, impl="ref")
    lk, _, h = ttr.forward(tp, cfg, batch, impl="kernel",
                           return_hidden=True)
    torch.testing.assert_close(lk, lr, **TOL)
    assert h.shape == (2, 16, cfg.d_model)
    none, _ = ttr.forward(tp, cfg, batch, apply_head=False)
    assert none is None
    with pytest.raises(ValueError, match="impl"):
        ttr.forward(tp, cfg, batch, impl="pallas")


@pytest.mark.parametrize("window", [0, 8])
def test_decode_step_matches_jax(window):
    """A 6-token prompt then 8 greedy tokens, token by token; window 8
    wraps the ring buffer (S = 8 slots for 14 positions). Logits every
    step and the whole cache at the end agree at 1e-5."""
    cfg = _cfg().with_(window=window)
    jp = jtr.init_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = tio.params_from_numpy(_np(jp), "cpu")
    prompt, _ = _tokens(cfg, B=2, S=6, seed=3)
    jc = jtr.init_cache(cfg, 2, 16, jnp.float32)
    tc = ttr.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert [tuple(t.shape) for t in leaves(tc)] == \
        [tuple(t.shape) for t in jax.tree.leaves(jc)]
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.tensor(prompt[:, :1])
    for pos in range(14):
        jl, jc = jtr.decode_step(jp, cfg, jc, jtok, jnp.int32(pos))
        tl, tc2 = ttr.decode_step(tp, cfg, tc, ttok, torch.tensor(pos))
        assert tc2 is tc                      # updated in place
        _close(tl, jl)
        if pos + 1 < prompt.shape[1]:
            jtok = jnp.asarray(prompt[:, pos + 1:pos + 2])
            ttok = torch.tensor(prompt[:, pos + 1:pos + 2])
        else:
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            ttok = torch.argmax(tl, -1)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for t, j in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(t, j)


def test_decode_of_unported_mixers_raises():
    """Every layer kind of the reference decodes now (its own tests:
    ``tests/test_torch_mla.py``, ``tests/test_torch_configs.py``); an
    unknown kind or input mode raises before touching a tensor."""
    cfg = _cfg()
    with pytest.raises(ValueError, match="unknown layer kind"):
        ttr.layer_cache_init("gqa:ssm", cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="unknown layer kind"):
        ttr.layer_decode({}, "rwkv:dense", None, cfg, {}, torch.tensor(0))
    with pytest.raises(ValueError, match="unknown input_mode"):
        ttr.init_cache(cfg.with_(input_mode="embeddings"), 1, 8,
                       torch.float32, device="cpu")
    for kind in ("gqa:moe_dense", "mla:dense", "mla:moe"):
        assert kind in ttr.PORTED_KINDS
        assert ttr.layer_cache_init(kind, cfg, 1, 8, torch.float32, "cpu")


def test_trunc_normal_in_place_equals_the_out_of_place_expression():
    """``trunc_normal`` works in place on its uniform draw; every value
    equals the out-of-place expression it replaced, bit for bit."""
    import math
    sq2 = math.sqrt(2.0)
    lo = 0.5 * (1.0 + math.erf(-2.0 / sq2))
    hi = 0.5 * (1.0 + math.erf(2.0 / sq2))
    for seed, shape, scale, dtype in ((0, (7,), 0.5, torch.float32),
                                      (1, (33, 65), 256 ** -0.5,
                                       torch.float32),
                                      (2, (3, 4, 129), 0.02, torch.bfloat16),
                                      (3, (2, 300, 7), 1.0, torch.float32)):
        u = torch.rand(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float32)
        x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * sq2
        want = (scale * x.clamp_(-2.0, 2.0)).to(dtype)
        got = tlayers.trunc_normal(torch.Generator().manual_seed(seed),
                                   shape, scale, dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        assert float(got.float().abs().max()) <= 2.0 * scale


# ---------------------------------------------------------------------------
# xlstm-1.3b: mLSTM and sLSTM blocks, their recurrent decode state
# ---------------------------------------------------------------------------
def _xcfg():
    return get_smoke_config("xlstm-1.3b")


def _dtype_names(tree, torch_side):
    if torch_side:
        return [str(t.dtype).split(".")[1] for t in leaves(tree)]
    return [str(np.asarray(x).dtype) for x in jax.tree.leaves(tree)]


def test_xlstm_params_tree_matches_jax_layout_bf16():
    """Keys, order, shapes and dtypes of the bf16 tree: the gate and
    recurrence leaves (w_if, b_if, r, b) are f32 in both packages, and
    ``params_from_numpy`` keeps each leaf's dtype."""
    cfg = _xcfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = ttr.init_params(0, cfg, torch.bfloat16, device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in leaves_with_path(tp)] == jpaths
    assert [tuple(t.shape) for t in leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    want = _dtype_names(jp, torch_side=False)
    assert _dtype_names(tp, torch_side=True) == want
    f32 = {p.rsplit("/", 1)[1] for p, d in zip(jpaths, want)
           if d == "float32"}
    assert f32 == {"w_if", "b_if", "r", "b"}
    assert _dtype_names(tio.params_from_numpy(_np(jp), "cpu"),
                        torch_side=True) == want
    assert ttr.count_params(tp) == jtr.count_params(jp)


def test_xlstm_npz_checkpoint_keeps_f32_leaves(tmp_path):
    """A bf16 xLSTM tree written by JAX restores bit for bit in the port
    with its f32 leaves f32, and back."""
    from repro.checkpoint import io as jio
    cfg = _xcfg()
    jp = jtr.init_params(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    jio.save_pytree(str(tmp_path / "j.npz"), jp)
    like = ttr.init_params(1, cfg, torch.bfloat16, device="cpu")
    tp = tio.restore_pytree(str(tmp_path / "j.npz"), like)
    assert _dtype_names(tp, True) == _dtype_names(jp, False)
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(tio.params_to_numpy(t), np.asarray(j))
    tio.save_pytree(str(tmp_path / "t.npz"), tp)
    back = jio.restore_pytree(str(tmp_path / "t.npz"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_xlstm_loss_matches_jax():
    cfg = _xcfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x, y = _tokens(cfg)
    jl, jm = jtr.loss_fn(jp, cfg, {"tokens": jnp.asarray(x),
                                   "labels": jnp.asarray(y)})
    tl, tm = ttr.loss_fn(tio.params_from_numpy(_np(jp), "cpu"), cfg,
                         {"tokens": torch.tensor(x),
                          "labels": torch.tensor(y)})
    _close(tl, jl)
    _close(tm["lm_loss"], jm["lm_loss"])


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_xlstm_prefill_matches_jax_pallas(impl):
    """Last-position logits over 32 tokens; ``impl="kernel"`` reaches
    ``ops.mlstm`` (its plain version on CPU tensors)."""
    cfg = _xcfg()
    jp = jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    x, _ = _tokens(cfg, B=2, S=32, seed=4)
    want = jtr.prefill(jp, cfg, {"tokens": jnp.asarray(x)}, impl="pallas")
    got = ttr.prefill(tio.params_from_numpy(_np(jp), "cpu"), cfg,
                      {"tokens": torch.tensor(x)}, impl=impl)
    assert tuple(got.shape) == (2, cfg.vocab_size)
    _close(got, want)


def test_xlstm_decode_step_matches_jax_with_states_in_place():
    """A 6-token prompt then 8 greedy tokens: logits every step, the
    greedy tokens, and every recurrent state at the end agree at 1e-5;
    ``decode_step`` returns the cache it was given, updated in place."""
    cfg = _xcfg()
    jp = jtr.init_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = tio.params_from_numpy(_np(jp), "cpu")
    prompt, _ = _tokens(cfg, B=2, S=6, seed=3)
    jc = jtr.init_cache(cfg, 2, 16, jnp.float32)
    tc = ttr.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert [p for p, _ in leaves_with_path(tc)] == [
        "0/p0/C", "0/p0/m", "0/p0/n", "0/p1/c", "0/p1/h", "0/p1/m", "0/p1/n"]
    assert [tuple(t.shape) for t in leaves(tc)] == \
        [tuple(t.shape) for t in jax.tree.leaves(jc)]
    for t, j in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(t, j)
    ptrs = [t.data_ptr() for t in leaves(tc)]
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.tensor(prompt[:, :1])
    for pos in range(14):
        jl, jc = jtr.decode_step(jp, cfg, jc, jtok, jnp.int32(pos))
        tl, tc2 = ttr.decode_step(tp, cfg, tc, ttok, torch.tensor(pos))
        assert tc2 is tc
        _close(tl, jl)
        if pos + 1 < prompt.shape[1]:
            jtok = jnp.asarray(prompt[:, pos + 1:pos + 2])
            ttok = torch.tensor(prompt[:, pos + 1:pos + 2])
        else:
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            ttok = torch.argmax(tl, -1)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert [t.data_ptr() for t in leaves(tc)] == ptrs
    for t, j in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(t, j)


# ---------------------------------------------------------------------------
# jamba-v0.1-52b: Mamba and MoE layers, the Mamba decode state
# ---------------------------------------------------------------------------
def _jcfg():
    return get_smoke_config("jamba-v0.1-52b")


def _layer_np(init, cfg, seed):
    return _np(init(jax.random.PRNGKey(seed), cfg, jnp.float32))


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_mamba_apply_matches_jax(impl):
    """One Mamba mixer over 24 tokens against JAX ``mamba_apply(impl=
    "pallas")`` (K6 in interpret mode) at 1e-5; the port's ``"kernel"``
    reaches ``ops.selective_scan`` (its plain version on CPU tensors)."""
    from repro.models import mamba as jmam
    from repro_torch.models import mamba as tmam
    cfg = _jcfg()
    p = _layer_np(jmam.mamba_init, cfg, 5)
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    want = jmam.mamba_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            cfg, impl="pallas")
    got = tmam.mamba_apply(tio.params_from_numpy(p, "cpu"), torch.tensor(x),
                           cfg, impl=impl)
    _close(got, want)


def test_mamba_decode_matches_jax_with_state_in_place():
    """Twelve tokens one at a time: outputs every step and the conv tail
    and SSM state at the end agree at 1e-5; the state is updated in place
    and equals the state a 12-token scan leaves."""
    from repro.models import mamba as jmam
    from repro_torch.models import mamba as tmam
    cfg = _jcfg()
    p = _layer_np(jmam.mamba_init, cfg, 6)
    jp, tp = jax.tree.map(jnp.asarray, p), tio.params_from_numpy(p, "cpu")
    x = np.random.default_rng(6).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jst = jmam.mamba_state_init(cfg, 2, jnp.float32)
    tst = tmam.mamba_state_init(cfg, 2, torch.float32, "cpu")
    ptrs = {k: t.data_ptr() for k, t in tst.items()}
    for t in range(12):
        jy, jst = jmam.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), cfg, jst,
                                    t)
        ty, tst2 = tmam.mamba_decode(tp, torch.tensor(x[:, t:t + 1]), cfg,
                                     tst, torch.tensor(t))
        assert tst2 is tst
        _close(ty, jy)
    assert {k: t.data_ptr() for k, t in tst.items()} == ptrs
    for key in ("conv", "ssm"):
        _close(tst[key], jst[key])
    _close(tmam.mamba_apply(tp, torch.tensor(x), cfg)[:, -1:], jy)


@pytest.mark.parametrize("factor,B,S,shared", [
    (0.5, 4, 32, 0),       # drops tokens, 8 dispatch groups
    (1.25, 2, 16, 0),      # the config's factor, 2 groups
    (1.25, 2, 16, 1),      # with a shared expert
    (4.0, 1, 8, 0),        # drop-free, one group
])
def test_moe_apply_matches_jax(factor, B, S, shared):
    """``moe_apply`` y and Switch aux loss at 1e-5 against JAX, over the
    grouped sort-based dispatch, including dropped tokens."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    cfg = _jcfg().with_(capacity_factor=factor, n_shared_experts=shared)
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    G = tmoe.n_groups(T, E)
    assert G == jmoe.n_groups(T, E)
    cap = tmoe.capacity(T // G, cfg)
    assert cap == jmoe.capacity(T // G, cfg)
    if factor == 0.5:
        assert G == 8 and G * E * cap < T * k      # some tokens must drop
    p = _layer_np(jmoe.moe_init, cfg, 7)
    assert ("shared" in p) == bool(shared)
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg)
    ty, taux = tmoe.moe_apply(tio.params_from_numpy(p, "cpu"),
                              torch.tensor(x), cfg)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux)


def test_jamba_params_tree_matches_jax_layout_bf16():
    """Keys, order, shapes and dtypes of the bf16 tree: ``A_log``, ``D``
    and the router are f32 in both packages, and ``params_from_numpy``
    keeps each leaf's dtype."""
    cfg = _jcfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = ttr.init_params(0, cfg, torch.bfloat16, device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in leaves_with_path(tp)] == jpaths
    assert [tuple(t.shape) for t in leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    want = _dtype_names(jp, torch_side=False)
    assert _dtype_names(tp, torch_side=True) == want
    f32 = {p.rsplit("/", 1)[1] for p, d in zip(jpaths, want)
           if d == "float32"}
    assert f32 == {"A_log", "D", "router"}
    assert _dtype_names(tio.params_from_numpy(_np(jp), "cpu"),
                        torch_side=True) == want
    assert ttr.count_params(tp) == jtr.count_params(jp)


def test_jamba_npz_checkpoint_keeps_f32_leaves(tmp_path):
    """A bf16 jamba tree written by JAX restores bit for bit in the port
    with its f32 leaves f32, and back."""
    from repro.checkpoint import io as jio
    cfg = _jcfg()
    jp = jtr.init_params(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    jio.save_pytree(str(tmp_path / "j.npz"), jp)
    like = ttr.init_params(1, cfg, torch.bfloat16, device="cpu")
    tp = tio.restore_pytree(str(tmp_path / "j.npz"), like)
    assert _dtype_names(tp, True) == _dtype_names(jp, False)
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(tio.params_to_numpy(t), np.asarray(j))
    tio.save_pytree(str(tmp_path / "t.npz"), tp)
    back = jio.restore_pytree(str(tmp_path / "t.npz"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jamba_loss_with_aux_matches_jax():
    """The loss sums the MoE layers' aux losses, as in JAX: total, LM and
    aux loss at 1e-5."""
    cfg = _jcfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x, y = _tokens(cfg)
    jl, jm = jtr.loss_fn(jp, cfg, {"tokens": jnp.asarray(x),
                                   "labels": jnp.asarray(y)})
    tl, tm = ttr.loss_fn(tio.params_from_numpy(_np(jp), "cpu"), cfg,
                         {"tokens": torch.tensor(x),
                          "labels": torch.tensor(y)})
    assert float(jm["aux_loss"]) > 0
    _close(tl, jl)
    _close(tm["lm_loss"], jm["lm_loss"])
    _close(tm["aux_loss"], jm["aux_loss"])


def test_jamba_every_gradient_matches_jax():
    """Training the Mamba and MoE layers: every gradient leaf of the loss
    (with the aux term) through the plain scan, which keeps each step's
    state under autograd, at 1e-5."""
    cfg = _jcfg()
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x, y = _tokens(cfg)
    (jl, _), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jp, cfg, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    tp = tio.params_from_numpy(_np(jp), "cpu")
    tparams = [t.requires_grad_() for t in leaves(tp)]
    tl, _ = ttr.loss_fn(tp, cfg, {"tokens": torch.tensor(x),
                                  "labels": torch.tensor(y)})
    _close(tl, jl)
    for g, want in zip(torch.autograd.grad(tl, tparams),
                       jax.tree.leaves(jg)):
        _close(g, want)
    # a state updated in place has no gradient: the plain scan refuses one
    from repro_torch.models.mamba import selective_scan_ref
    xc = torch.ones((1, 2, 4), requires_grad=True)
    ones = (torch.ones((1, 2, 4)), torch.ones((1, 2, 2)),
            torch.ones((1, 2, 2)), -torch.ones((4, 2)), torch.ones(4))
    with pytest.raises(ValueError, match="h0"):
        selective_scan_ref(xc, *ones, h0=torch.zeros((1, 4, 2)))


def test_phi4_tied_embeddings_loss_and_gradients_match_jax():
    """phi4-mini-3.8b's smoke config (tied embeddings: no ``head`` leaf,
    the LM head reads the embedding table): the tree's keys, the loss and
    every gradient leaf at 1e-5."""
    from repro_torch.configs import get_smoke_config as t_smoke
    cfg = get_smoke_config("phi4-mini-3.8b")
    tcfg = t_smoke("phi4-mini-3.8b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    assert tcfg.tie_embeddings and "head" not in ttr.init_params(
        0, tcfg, torch.float32, device="cpu")
    x, y = _tokens(cfg)
    (jl, _), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jp, cfg, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    tp = tio.params_from_numpy(_np(jp), "cpu")
    tparams = [t.requires_grad_() for t in leaves(tp)]
    tl, _ = ttr.loss_fn(tp, tcfg, {"tokens": torch.tensor(x),
                                   "labels": torch.tensor(y)})
    _close(tl, jl)
    for g, want in zip(torch.autograd.grad(tl, tparams),
                       jax.tree.leaves(jg)):
        _close(g, want)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_jamba_prefill_matches_jax_pallas(impl):
    """Last-position logits over 32 tokens against JAX ``prefill(impl=
    "pallas")`` (K5 and K6 in interpret mode) at 1e-5."""
    cfg = _jcfg()
    jp = jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    x, _ = _tokens(cfg, B=2, S=32, seed=4)
    want = jtr.prefill(jp, cfg, {"tokens": jnp.asarray(x)}, impl="pallas")
    got = ttr.prefill(tio.params_from_numpy(_np(jp), "cpu"), cfg,
                      {"tokens": torch.tensor(x)}, impl=impl)
    assert tuple(got.shape) == (2, cfg.vocab_size)
    _close(got, want)


def test_jamba_decode_step_matches_jax_with_states_in_place():
    """A 6-token prompt then 8 greedy tokens through the Mamba + MoE layer
    and the attention layer: logits every step, the greedy tokens, and
    every cache leaf at the end agree at 1e-5; ``decode_step`` updates the
    cache it was given in place."""
    cfg = _jcfg()
    jp = jtr.init_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    tp = tio.params_from_numpy(_np(jp), "cpu")
    prompt, _ = _tokens(cfg, B=2, S=6, seed=3)
    jc = jtr.init_cache(cfg, 2, 16, jnp.float32)
    tc = ttr.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert [p for p, _ in leaves_with_path(tc)] == [
        "0/p0/conv", "0/p0/ssm", "0/p1/k", "0/p1/v"]
    assert [tuple(t.shape) for t in leaves(tc)] == \
        [tuple(t.shape) for t in jax.tree.leaves(jc)]
    ptrs = [t.data_ptr() for t in leaves(tc)]
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.tensor(prompt[:, :1])
    for pos in range(14):
        jl, jc = jtr.decode_step(jp, cfg, jc, jtok, jnp.int32(pos))
        tl, tc2 = ttr.decode_step(tp, cfg, tc, ttok, torch.tensor(pos))
        assert tc2 is tc
        _close(tl, jl)
        if pos + 1 < prompt.shape[1]:
            jtok = jnp.asarray(prompt[:, pos + 1:pos + 2])
            ttok = torch.tensor(prompt[:, pos + 1:pos + 2])
        else:
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            ttok = torch.argmax(tl, -1)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert [t.data_ptr() for t in leaves(tc)] == ptrs
    for t, j in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(t, j)
