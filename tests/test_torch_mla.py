"""The port's Multi-head Latent Attention and deepseek-v3-671b's smoke
config against the JAX package.

Parameters are JAX-initialised and carried across with
``repro_torch.checkpoint.io.params_from_numpy``; inputs come from numpy
with a fixed seed; f32 on both sides, 1e-5. ``mla_apply`` (the absorbed
latent attention through ``chunked_attention`` over one shared KV head,
with and without a sliding window), ``mla_decode`` over the latent cache,
which the port updates in place, and ``mla_cache_reset_``; then the
whole smoke model: the bf16 tree and its npz round trip, the loss with
the MTP head and the MoE aux loss and every gradient, ``prefill`` and
``decode_step``, and decode against the full forward at a drop-free
capacity factor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import mla as jmla
from repro.models import transformer as jtr
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves, leaves_with_path

TOL = {"rtol": 1e-5, "atol": 1e-5}
ARCH = "deepseek-v3-671b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _cfg(**kw):
    return get_smoke_config(ARCH).with_(**kw)


def _tokens(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y[0, :3] = -1
    return x, y


def _mla_params(cfg, seed=0):
    p = _np(jmla.mla_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    # the norms' gains start at one: draw them, or they test nothing
    rng = np.random.default_rng(seed + 10)
    for name in ("q_norm_g", "kv_norm_g"):
        p[name] = (1.0 + 0.3 * rng.standard_normal(p[name].shape)).astype(
            np.float32)
    return p


@pytest.mark.parametrize("window", [0, 8])
def test_mla_apply_matches_jax(window):
    """y and the latents it returns for caching, over 24 positions in
    chunks of 8 (three q and three kv chunks of the online softmax)."""
    cfg = _cfg(window=window)
    p = _mla_params(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jy, (jc, jr) = jmla.mla_apply(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), cfg, jnp.asarray(pos))
    ty, (tc, tr_) = tmla.mla_apply(tio.params_from_numpy(p, "cpu"),
                                   torch.tensor(x), cfg, torch.tensor(pos),
                                   impl="kernel")
    _close(ty, jy)
    _close(tc, jc)
    _close(tr_, jr)
    # the shared-KV path of chunked_attention at several chunk sizes
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    q = rng.standard_normal((2, 24, 4, 12)).astype(np.float32)
    k = rng.standard_normal((2, 24, 1, 12)).astype(np.float32)
    v = rng.standard_normal((2, 24, 1, 10)).astype(np.float32)
    for chunk in (8, 24):
        kw = {"n_kv_heads": 1, "window": window, "chunk_q": chunk,
              "chunk_kv": chunk, "softmax_scale": 0.2}
        _close(tattn.chunked_attention(*map(torch.tensor, (q, k, v)), **kw),
               jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("window", [0, 4])
def test_mla_decode_writes_the_latent_cache_in_place(window):
    """10 steps against a cache of 6 slots (a ring of 4 under the window):
    y every step and the whole cache after it at 1e-5, the cache written
    in place; ``mla_cache_reset_`` gives back ``mla_cache_init``'s zeros
    in the same storage."""
    cfg = _cfg(window=window)
    p = _mla_params(cfg, seed=2)
    jp, tp = jax.tree.map(jnp.asarray, p), tio.params_from_numpy(p, "cpu")
    steps = 10 if window else 6
    jc = jmla.mla_cache_init(cfg, 2, 6, jnp.float32)
    tc = tmla.mla_cache_init(cfg, 2, 6, torch.float32, "cpu")
    assert sorted(tc) == sorted(jc) == ["c_kv", "k_rope"]
    assert [tuple(tc[k].shape) for k in sorted(tc)] == \
        [tuple(jc[k].shape) for k in sorted(jc)]
    ptrs = {k: t.data_ptr() for k, t in tc.items()}
    rng = np.random.default_rng(3)
    for pos in range(steps):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jmla.mla_decode(jp, jnp.asarray(x), cfg, jc,
                                 jnp.int32(pos))
        ty, tc2 = tmla.mla_decode(tp, torch.tensor(x), cfg, tc,
                                  torch.tensor(pos))
        assert tc2 is tc
        _close(ty, jy)
        for k in tc:
            _close(tc[k], jc[k])
    assert {k: t.data_ptr() for k, t in tc.items()} == ptrs
    assert float(tc["c_kv"].abs().sum()) > 0
    assert tmla.mla_cache_reset_(tc) is tc
    assert {k: t.data_ptr() for k, t in tc.items()} == ptrs
    fresh = tmla.mla_cache_init(cfg, 2, 6, torch.float32, "cpu")
    for k in tc:
        assert torch.equal(tc[k], fresh[k])


def test_deepseek_params_tree_matches_jax_layout_bf16():
    """Keys, order, shapes and dtypes of the bf16 tree (the MLA leaves, the
    routed and shared experts, the MTP head with its layer stacked (1,)),
    the router f32 in both, and the configs equal field by field."""
    import dataclasses
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(t_smoke(ARCH)) == dataclasses.asdict(cfg)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = ttr.init_params(0, cfg, torch.bfloat16, device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = [p for p, _ in leaves_with_path(tp)]
    assert tpaths == jpaths
    assert "mtp/layer/mixer/w_uk" in tpaths
    assert "mtp/layer/ffn/shared/wi" in tpaths
    assert [tuple(t.shape) for t in leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert tuple(tp["mtp"]["layer"]["mixer"]["w_dq"].shape) == (
        1, cfg.d_model, cfg.q_lora_rank)
    want = [str(x.dtype) for x in jax.tree.leaves(jp)]
    got = [str(t.dtype).replace("torch.", "") for t in leaves(tp)]
    assert got == want
    assert {p.rsplit("/", 1)[1] for p, d in zip(jpaths, want)
            if d == "float32"} == {"router"}
    assert ttr.count_params(tp) == jtr.count_params(jp)


def test_deepseek_npz_checkpoint_crosses_packages(tmp_path):
    """A bf16 deepseek tree written by JAX restores bit for bit in the
    port, and the port's npz restores in JAX."""
    from repro.checkpoint import io as jio
    cfg = get_smoke_config(ARCH)
    jp = jtr.init_params(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    jio.save_pytree(str(tmp_path / "j.npz"), jp)
    like = ttr.init_params(1, cfg, torch.bfloat16, device="cpu")
    tp = tio.restore_pytree(str(tmp_path / "j.npz"), like)
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(tio.params_to_numpy(t), np.asarray(j))
    tio.save_pytree(str(tmp_path / "t.npz"), tp)
    back = jio.restore_pytree(str(tmp_path / "t.npz"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def deepseek_f32():
    cfg = get_smoke_config(ARCH)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, jp, _np(jp)


def test_deepseek_loss_with_mtp_and_every_gradient(deepseek_f32):
    """Total, LM, aux and MTP losses and every gradient leaf (the MTP
    head's included) at 1e-5."""
    cfg, jp, npp = deepseek_f32
    x, y = _tokens(cfg)
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, cfg, b), has_aux=True))(jp, jb)
    tp = tio.params_from_numpy(npp, "cpu")
    tparams = [t.requires_grad_() for t in leaves(tp)]
    tl, tm = ttr.loss_fn(tp, cfg, {"tokens": torch.tensor(x),
                                   "labels": torch.tensor(y)})
    assert sorted(tm) == sorted(jm)
    assert float(jm["mtp_loss"]) > 0 and float(jm["aux_loss"]) > 0
    for k in jm:
        _close(tm[k], jm[k])
    grads = torch.autograd.grad(tl, tparams)
    for (path, _), g, want in zip(leaves_with_path(tp), grads,
                                  jax.tree.leaves(jg)):
        _close(g, want)
        if path.startswith("mtp/"):
            assert float(g.abs().max()) > 0, path


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_deepseek_prefill_matches_jax(deepseek_f32, impl):
    """Last-position logits over 32 tokens; MLA ignores ``impl`` in both
    packages (the kernel path reaches no flash kernel here)."""
    cfg, jp, npp = deepseek_f32
    x, _ = _tokens(cfg, B=2, S=32, seed=4)
    want = jtr.prefill(jp, cfg, {"tokens": jnp.asarray(x)}, impl="pallas")
    got = ttr.prefill(tio.params_from_numpy(npp, "cpu"), cfg,
                      {"tokens": torch.tensor(x)}, impl=impl)
    assert tuple(got.shape) == (2, cfg.vocab_size)
    _close(got, want)


def test_deepseek_decode_step_matches_jax_with_cache_in_place(deepseek_f32):
    """A 6-token prompt then 8 greedy tokens through the ``mla:dense`` and
    ``mla:moe`` layers: logits every step, the greedy tokens and every
    latent cache leaf at 1e-5, the cache written in place; then
    ``reset_cache_`` zeros it in the same storage."""
    cfg, jp, npp = deepseek_f32
    tp = tio.params_from_numpy(npp, "cpu")
    prompt, _ = _tokens(cfg, B=2, S=6, seed=3)
    jc = jtr.init_cache(cfg, 2, 16, jnp.float32)
    tc = ttr.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert [p for p, _ in leaves_with_path(tc)] == [
        "0/p0/c_kv", "0/p0/k_rope", "1/p0/c_kv", "1/p0/k_rope"]
    assert [tuple(t.shape) for t in leaves(tc)] == \
        [tuple(t.shape) for t in jax.tree.leaves(jc)]
    ptrs = [t.data_ptr() for t in leaves(tc)]
    jstep = jax.jit(lambda p, c, t, i: jtr.decode_step(p, cfg, c, t, i))
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.tensor(prompt[:, :1])
    for pos in range(14):
        jl, jc = jstep(jp, jc, jtok, jnp.int32(pos))
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
    ttr.reset_cache_(cfg, tc)
    assert [t.data_ptr() for t in leaves(tc)] == ptrs
    assert all(float(t.abs().max()) == 0 for t in leaves(tc))


def test_deepseek_decode_matches_forward():
    """Token-by-token decode logits equal the full-sequence forward's at
    1e-5, without the MTP head and at a drop-free capacity factor (which
    tokens a capacity drops depends on how many a call sees), as
    ``tests/test_models_smoke.py`` holds the JAX package (at 2e-3)."""
    cfg = _cfg(mtp_depth=0, capacity_factor=4.0)
    jp = jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = tio.params_from_numpy(_np(jp), "cpu")
    assert "mtp" not in tp
    x, _ = _tokens(cfg, B=2, S=8, seed=5)
    full, _ = ttr.forward(tp, cfg, {"tokens": torch.tensor(x)})
    jfull, _ = jtr.forward(jp, cfg, {"tokens": jnp.asarray(x)})
    _close(full, jfull)
    cache = ttr.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    dec = []
    for t in range(8):
        lg, cache = ttr.decode_step(tp, cfg, cache,
                                    torch.tensor(x[:, t:t + 1]),
                                    torch.tensor(t))
        dec.append(lg[:, 0])
    _close(torch.stack(dec, 1), full.detach().numpy())
