"""Wire kernels K1-K4, flash attention K5, the selective scan K6, mLSTM K7
and decode attention K8 of the PyTorch port against the JAX package.

CPU half: the port's plain versions (``repro_torch/kernels/ref.py``) are
held against the JAX oracles (``repro/kernels/ref.py``, ``impl="ref"``)
and the Pallas kernel bodies run in interpret mode (``impl="interpret"``),
as ``tests/test_kernels.py`` runs them. Packed payloads are bit-exact;
8/4-bit scales are exact against the oracle (the interpret-mode kernel's
``amax / qmax`` may differ from it by one f32 ULP, and the 1-bit mean's
summation order differs everywhere, hence rtol 1e-6 there).

K5's plain version is held against the JAX oracle and the Pallas kernel
in interpret mode (``block_q = block_k = 64``) over ``test_kernels.py``'s
sweep: f32 at 2e-5, bf16 at 2e-2 (bf16 inputs are rounded from the same
f32 numbers on both sides).

K7's plain version (``ref.mlstm_ref``, the model's ``mlstm_cell_ref``) is
held against the JAX oracle at 1e-5, from the zero state and from a
carried one, and against the Pallas kernel in interpret mode over
``test_kernels.py``'s sweep at 2e-4 (the JAX suite's tolerance for K7).

K6's plain version (``ref.selective_scan_ref``, the model's) is held
against the JAX oracle, from the zero state and from a carried one, and
against the Pallas kernel in interpret mode over ``test_kernels.py``'s
sweep, at the JAX suite's 1e-5 (y and the final state).

The arithmetic of K5's and K7's tensor-core designs is held here too, in
plain torch helpers on no path: 3xTF32 products (TF32 rounding emulated)
inside causal attention against the JAX oracle at 2e-5, with plain TF32
shown to miss it; and K7's chunkwise passes (stepwise m, within-chunk F,
weighted scores G, boundary states, outputs) against the JAX oracle and
the Pallas kernel at 2e-4, around chunk boundaries and in the three gate
regimes of ``chip_smoke.py``.

K6's arithmetic (``csrc/selective_scan.cu``) is held here the same way:
its order — A's row prescaled by log2(e), exp2(dt·a2) as the SFU's
``ex2.approx`` (exact, or off by its 2-ulp bound in either direction in
every exp), (dt·B)·x as the plain version forms it, h and y_t by fused
multiply-adds, y_t summed in one chain — against the JAX
oracle at 1e-5 in three regimes (the JAX suite's draw, Mamba's
initialisation, strong decay).

K8's plain version (``ref.decode_attention_ref``, the JAX package's
``decode_attend`` op for op) is held against the JAX package at 1e-6 and
against K8's split (64-slot chunks of the valid slots, merged in order) in
plain torch, around chunk boundaries and a wrapped sliding window.

The card half — each hand-written CUDA kernel against its plain version
on the same CUDA inputs — is ``tests/test_torch_gpu.py``, which imports no
JAX so that it runs on a machine with a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantize import ROWS
from repro_torch.kernels import comm as tcomm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tqz
from repro_torch.kernels import ref as tref

SHAPES = [(1000, 37), (256,), (3 * 256 + 100,), (8, 8, 8)]
BUFS = [(1, 8 * 256), (3, 16 * 256), (5, 8 * 256 + 300)]


def _x(shape, seed=0, scale=5.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tol(bits):
    # test_kernels.py: rtol 1e-7 / atol 1e-6 at 8 bits, 2e-6 at 4 and 1
    return ({"rtol": 1e-7, "atol": 1e-6} if bits == 8
            else {"rtol": 2e-6, "atol": 2e-6})


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_quantize_plain_matches_jax(bits, shape):
    x = _x(shape)
    q_r, s_r, shp = jref.quantize_blockwise_ref(jnp.asarray(x), bits=bits)
    q_i, s_i, _ = jops.quantize_blockwise(jnp.asarray(x), bits=bits,
                                          impl="interpret")
    q_t, s_t, shp_t = tops.quantize_blockwise(torch.tensor(x), bits=bits)
    assert shp_t == tuple(shp)
    nb = q_r.shape[0]                     # oracle: no ROWS padding
    assert q_t.shape[0] == nb and q_i.shape[0] % ROWS == 0
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_i)[:nb])
    if bits == 1:
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-6)
    else:
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_i)[:nb], rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("shape", SHAPES + [(3 * 256,)])
def test_k2_dequantize_plain_matches_jax(bits, shape):
    """Same payload into both; (3*256,) has nb % ROWS != 0, which the
    Pallas grid used to drop (test_kernels.py:136)."""
    q, s, shp = jref.quantize_blockwise_ref(jnp.asarray(_x(shape)),
                                            bits=bits)
    want = jref.dequantize_blockwise_ref(q, s, shp, bits=bits)
    got_i = jops.dequantize_blockwise(q, s, shp, bits=bits,
                                      impl="interpret")
    got = tops.dequantize_blockwise(torch.tensor(np.asarray(q)),
                                    torch.tensor(np.asarray(s)), shp,
                                    bits=bits)
    assert tuple(got.shape) == tuple(shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(got_i))


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_pack_unpack_codes_match_jax(bits):
    from repro.kernels.quantize import pack_codes
    rng = np.random.default_rng(1)
    qmax = 1 if bits == 1 else 2 ** (bits - 1) - 1
    q = rng.integers(-qmax, qmax + 1, (6, 256)).astype(np.int8)
    if bits == 1:
        q = np.where(q >= 0, 1, -1).astype(np.int8)
    p_t = tqz.pack_codes(torch.tensor(q), bits)
    np.testing.assert_array_equal(p_t.numpy(),
                                  np.asarray(pack_codes(jnp.asarray(q), bits)))
    np.testing.assert_array_equal(tqz.unpack_codes(p_t, bits).numpy(), q)


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("K,n", BUFS)
def test_k3_quant_avg_dequant_plain_matches_jax(bits, K, n):
    buf = _x((K, n), seed=2, scale=3.0)
    m_r = jref.quant_avg_dequant_ref(jnp.asarray(buf), bits=bits)
    m_i = jops.quant_avg_dequant(jnp.asarray(buf), bits=bits,
                                 impl="interpret")
    m_t = tops.quant_avg_dequant(torch.tensor(buf), bits=bits)
    assert tuple(m_t.shape) == (n,)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_r), **_tol(bits))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_i), **_tol(bits))


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("K,n", BUFS)
def test_k4_quant_avg_dequant_ef_plain_matches_jax(bits, K, n):
    buf = _x((K, n), seed=3, scale=2.0)
    res = _x((K, n), seed=4, scale=0.1)
    m_r, e_r = jref.quant_avg_dequant_ef_ref(jnp.asarray(buf),
                                             jnp.asarray(res), bits=bits)
    m_i, e_i = jops.quant_avg_dequant_ef(jnp.asarray(buf), jnp.asarray(res),
                                         bits=bits, impl="interpret")
    res_t = torch.tensor(res)
    m_t, e_t = tops.quant_avg_dequant_ef(torch.tensor(buf), res_t, bits=bits)
    assert e_t is res_t                   # new residual written in place
    for want_m, want_e in ((m_r, e_r), (m_i, e_i)):
        np.testing.assert_allclose(m_t.numpy(), np.asarray(want_m),
                                   **_tol(bits))
        np.testing.assert_allclose(e_t.numpy(), np.asarray(want_e),
                                   **_tol(bits))


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_k4_zero_residual_mean_is_k3_bitwise(bits):
    buf = torch.tensor(_x((4, 8 * 256), seed=5, scale=2.0))
    m_plain = tops.quant_avg_dequant(buf, bits=bits)
    m_ef, e = tops.quant_avg_dequant_ef(buf, torch.zeros_like(buf),
                                        bits=bits)
    np.testing.assert_array_equal(m_ef.numpy(), m_plain.numpy())
    m_j = jref.quant_avg_dequant_ref(jnp.asarray(buf.numpy()), bits=bits)
    np.testing.assert_allclose(m_ef.numpy(), np.asarray(m_j), **_tol(bits))
    assert torch.isfinite(e).all()


def test_zero_padding_stays_zero():
    """All-zero rows: scale 1.0 at 8/4 bits, 0 at 1 bit; zeros out."""
    x = torch.zeros(3 * 256)
    for bits in (8, 4, 1):
        q, s, shp = tops.quantize_blockwise(x, bits=bits)
        assert (s == (0.0 if bits == 1 else 1.0)).all()
        assert (tops.dequantize_blockwise(q, s, shp, bits=bits) == 0).all()
        assert (tops.quant_avg_dequant(torch.zeros(2, 300),
                                       bits=bits) == 0).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: a kernel wrapper handed a CPU tensor raises; only the
    dispatcher routes CPU tensors to the plain versions."""
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tqz.quantize_blockwise_fwd(x)
    with pytest.raises(ValueError, match="CUDA"):
        tqz.dequantize_blockwise_fwd(torch.zeros(1, 256, dtype=torch.int8),
                                     torch.ones(1), (256,))
    with pytest.raises(ValueError, match="CUDA"):
        tcomm.quant_avg_dequant_fwd(x)
    with pytest.raises(ValueError, match="CUDA"):
        tcomm.quant_avg_dequant_ef_fwd(x, x.clone())
    assert all(v == 0 for v in tops.launch_counts().values())



# ---------------------------------------------------------------------------
# K5: flash attention, plain version against the JAX oracle and kernel
# ---------------------------------------------------------------------------
def _qkv(B, Sq, Sk, H, KV, hd, hd_v=None, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd_v or hd)).astype(np.float32))


def _fa_both(q, k, v, dtype, **kw):
    """(port plain version, JAX oracle, JAX interpret-mode kernel), f32."""
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    got = tops.flash_attention(*(torch.tensor(a).to(td) for a in (q, k, v)),
                               **kw)
    assert got.dtype == td
    want = jref.flash_attention_ref(jq, jk, jv, **kw)
    pal = jops.flash_attention(jq, jk, jv, impl="interpret", block_q=64,
                               block_k=64, **kw)
    return (got.float().numpy(), np.asarray(want, np.float32),
            np.asarray(pal, np.float32))


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 32),      # MHA
    (2, 256, 8, 2, 64),      # GQA
    (1, 128, 4, 1, 32),      # MQA
    (2, 512, 4, 2, 128),     # longer, full head size
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k5_flash_attention_plain_matches_jax(B, S, H, KV, hd, dtype):
    got, want, pal = _fa_both(*_qkv(B, S, S, H, KV, hd), dtype,
                              n_kv_heads=KV)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pal, rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [32, 128])
def test_k5_sliding_window_plain_matches_jax(window):
    got, want, pal = _fa_both(*_qkv(1, 256, 256, 4, 2, 32), "f32",
                              n_kv_heads=2, window=window)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pal, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_k5_fewer_queries_than_keys_plain_matches_jax(window):
    """Sq < Sk: query row i sits at key position i + (Sk - Sq); hd_v
    differs from hd and the scale is given explicitly."""
    got, want, pal = _fa_both(*_qkv(2, 64, 192, 4, 2, 32, hd_v=16), "f32",
                              n_kv_heads=2, window=window,
                              softmax_scale=0.3)
    assert got.shape == (2, 64, 4, 16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pal, rtol=2e-5, atol=2e-5)


def test_k5_wrapper_refuses_cpu_tensors_and_grad():
    """No fallback: K5's wrapper takes CUDA tensors only, and it is
    forward only — inputs that require grad raise while grad is on."""
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = (torch.tensor(a) for a in _qkv(1, 16, 16, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v, n_kv_heads=2)
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.flash_attention_fwd(qg, k, v, n_kv_heads=2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(qg, k, v, n_kv_heads=2)
    # the dispatcher sends CPU tensors to the plain version, never K5
    out = tops.flash_attention(q, k, v, n_kv_heads=2)
    assert out.shape == (1, 16, 4, 8)
    with pytest.raises(ValueError, match="one device"):
        tops.flash_attention(q, k.to("meta"), v, n_kv_heads=2)
    assert tops.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------------------------------
# K8: decode attention, plain version against the JAX package's decode and
# the kernel's split order; the wrapper's refusals; the ServeLoop's count
# ---------------------------------------------------------------------------
def _k8_inputs(B, S, H, KV, hd, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _k8_split(q, ck, cv, pos, scale, chunk=64):
    """K8's split in plain torch (``csrc/decode_attention.cu``): the
    ``min(pos + 1, S)`` valid slots in chunks of ``chunk``, each chunk's
    max, sum and unnormalised P·V per head, the chunks merged in order."""
    B, _, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    n = min(int(pos) + 1, S)
    qg = (q[:, 0] * scale).view(B, KV, H // KV, hd)
    ms, ls, accs = [], [], []
    for s0 in range(0, n, chunk):
        s = torch.einsum("bkgd,bckd->bkgc", qg, ck[:, s0:min(n, s0 + chunk)])
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckd->bkgd", p,
                                 cv[:, s0:min(n, s0 + chunk)]))
    M = torch.stack(ms).amax(0)
    w = [torch.exp(m - M) for m in ms]
    L = sum(wi * li for wi, li in zip(w, ls))
    o = sum(wi[..., None] * a for wi, a in zip(w, accs)) / L[..., None]
    return o.reshape(B, 1, H, hd)


# (B, S, H, KV, hd, window, pos): G 1, 2, 3 and 8; B odd; S not a multiple
# of K8's 64-slot chunk; pos at 0, a chunk's last slot, the next chunk's
# first, S - 1; a sliding window's ring before and after it wraps
K8_CASES = [(3, 100, 4, 4, 64, 0, 0), (3, 100, 8, 4, 32, 0, 63),
            (1, 100, 6, 2, 32, 0, 64), (2, 100, 16, 2, 128, 0, 99),
            (3, 100, 8, 4, 32, 100, 99), (3, 100, 8, 4, 32, 100, 100),
            (2, 70, 6, 2, 64, 70, 250)]


@pytest.mark.parametrize("B,S,H,KV,hd,window,pos", K8_CASES)
def test_k8_decode_attention_plain_matches_jax(B, S, H, KV, hd, window, pos):
    """``ops.decode_attention`` on CPU tensors is ``decode_attend``'s
    output bit for bit, the JAX package's ``decode_attend`` at 1e-6, and
    K8's split over 64-slot chunks (valid slots ``min(pos + 1, S)``,
    window or not) at 1e-6."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    q, k, v = _k8_inputs(B, S, H, KV, hd)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    kw = {"window": window, "softmax_scale": hd ** -0.5}
    got = tops.decode_attention(tq, tk, tv, torch.tensor(pos), **kw)
    assert got.shape == (B, 1, H, hd)
    assert torch.equal(got, tattn.decode_attend(tq, tk, tv,
                                                torch.tensor(pos), **kw))
    want = jattn.decode_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    split = _k8_split(tq, tk, tv, pos, hd ** -0.5)
    np.testing.assert_allclose(split.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert tops.launch_counts()["decode_attention"] == 0


def test_k8_wrapper_refuses_what_it_cannot_take(tmp_path):
    """K8's wrapper raises on grad, wrong dtypes and shapes, G > 8, hd >
    128 or not a multiple of 4, a bad ``pos`` and CPU tensors; the
    dispatcher raises on a DTensor and never falls back."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.launch import mesh
    fwd = tda.decode_attention_fwd
    kw = {"window": 0, "softmax_scale": 0.125}
    pos = torch.tensor(3)

    def qkv(B=2, S=16, H=8, KV=4, hd=32):
        return tuple(torch.tensor(a) for a in _k8_inputs(B, S, H, KV, hd))
    q, k, v = qkv()
    with pytest.raises(RuntimeError, match="forward only"):
        fwd(q.clone().requires_grad_(), k, v, pos, **kw)
    with pytest.raises(ValueError, match="float32"):
        fwd(q.bfloat16(), k, v, pos, **kw)
    with pytest.raises(ValueError, match="float32"):
        fwd(q[:, 0], k, v, pos, **kw)
    for bad in ((q.expand(2, 2, 8, 32), k, v), (q, k, v[:, :8]),
                (q[:, :, :6], k, v), (q, k[:, :0], v[:, :0])):
        with pytest.raises(ValueError, match="shapes"):
            fwd(*bad, pos, **kw)
    for bad in (torch.tensor([3]), torch.tensor(3.0)):
        with pytest.raises(ValueError, match="pos"):
            fwd(q, k, v, bad, **kw)
    for shape in ({"H": 18, "KV": 2}, {"hd": 256}, {"hd": 30}):
        with pytest.raises(ValueError, match="outside this kernel"):
            fwd(*qkv(**shape), pos, **kw)
    with pytest.raises(ValueError, match="window"):
        fwd(q, k, v, pos, window=-1, softmax_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(q, k, v, pos, **kw)
    with pytest.raises(ValueError, match="one device"):
        tops.decode_attention(q, k.to("meta"), v, pos, **kw)
    mesh.init_process_mesh(0, 1, f"file://{tmp_path}/rdv", "gloo", "cpu")
    try:
        dm = mesh.make_sim_mesh((1,), ("model",), "cpu")
        dq = distribute_tensor(q, dm, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            tops.decode_attention(dq, k, v, pos, **kw)
    finally:
        dist.destroy_process_group()
    assert fwd.launches == 0


def test_k8_counts_one_launch_per_attention_layer_a_step(monkeypatch):
    """Through the card's dispatch (the wrapper stood in for by its plain
    version, counting as it does): building a ServeLoop runs its step once
    (the capture), one K8 launch per attention layer, and every prompt and
    decode step adds one a layer, so the counter over the replays says how
    often K8 ran. MLA and recurrent layers never reach it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models import transformer as ttr
    from repro_torch.serving import ServeLoop
    real = tda.decode_attention_fwd

    def stand_in(q, ck, cv, pos, *, window, softmax_scale):
        real.launches += 1
        return tref.decode_attention_ref(q, ck, cv, pos, window=window,
                                         softmax_scale=softmax_scale)
    monkeypatch.setattr(tops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(tda, "decode_attention_fwd", stand_in)
    monkeypatch.setattr(real, "launches", 0)
    P, new = 3, 2
    for arch, n_attn in (("internlm2-1.8b", None), ("jamba-v0.1-52b", None),
                         ("deepseek-v3-671b", 0)):
        cfg = get_smoke_config(arch)
        if n_attn is None:
            n_attn = sum(r for pat, r in cfg.segments for kind in pat
                         if kind.startswith("gqa:"))
            assert n_attn >= 1
        real.launches = 0
        params = ttr.init_params(0, cfg, torch.float32, device="cpu")
        loop = ServeLoop(cfg, params, batch=2, max_seq=8, device="cpu")
        assert real.launches == n_attn * loop.compile_count() == n_attn
        prompts = torch.zeros((2, P), dtype=torch.int64)
        loop.generate(prompts, new)
        assert real.launches == n_attn * (1 + P + new)


def test_build_tables_are_per_library(monkeypatch, tmp_path):
    """Each library gets its own entry points and flags: the wire kernels
    keep -fmad=false, flash attention and mLSTM do not, and the flags are
    part of the library's path."""
    from repro_torch.kernels import _build
    assert set(_build.API) == set(_build.NVCC_FLAGS) == {
        "wire", "flash_attention", "mlstm", "selective_scan",
        "decode_attention"}
    assert "-fmad=false" in _build.NVCC_FLAGS["wire"]
    for name in ("flash_attention", "mlstm", "selective_scan",
                 "decode_attention"):
        assert "-fmad=false" not in _build.NVCC_FLAGS[name]
    assert set(_build.API["flash_attention"]) == {"flash_attention_fwd"}
    assert set(_build.API["mlstm"]) == {"mlstm_fwd"}
    assert len(_build.API["mlstm"]["mlstm_fwd"]) == 15
    assert set(_build.API["selective_scan"]) == {"selective_scan_fwd"}
    assert len(_build.API["selective_scan"]["selective_scan_fwd"]) == 14
    assert set(_build.API["decode_attention"]) == {"decode_attention_fwd"}
    assert len(_build.API["decode_attention"]["decode_attention_fwd"]) == 14
    path = _build.lib_path("flash_attention")
    assert path.name == "libflash_attention.so"
    monkeypatch.setitem(_build.NVCC_FLAGS, "flash_attention",
                        _build.NVCC_FLAGS["flash_attention"] + ("-G",))
    assert _build.lib_path("flash_attention") != path

    class FakeLib:       # holds only the flash entry point, like the .so
        def __init__(self):
            self.flash_attention_fwd = type("Fn", (), {})()

    monkeypatch.setattr(_build, "build", lambda name: tmp_path / name)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_LOADED", {})
    lib = _build.load("flash_attention")
    assert len(lib.flash_attention_fwd.argtypes) == 15


def test_build_path_hashes_the_shared_headers(monkeypatch, tmp_path):
    """A library's path changes with the bytes of any header under
    ``csrc/`` (K5 and K7 include ``tf32_mma.cuh``), so a changed header
    never loads a stale library; ``csrc/`` is on nvcc's include path."""
    from repro_torch.kernels import _build
    for f in ("mlstm.cu", "tf32_mma.cuh"):
        (tmp_path / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    path = _build.lib_path("mlstm")
    assert path == _build.lib_path("mlstm")
    header = tmp_path / "tf32_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    edited = _build.lib_path("mlstm")
    assert edited != path
    (tmp_path / "extra.cuh").write_bytes(b"// another header\n")
    assert _build.lib_path("mlstm") not in (path, edited)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.build_cmd("mlstm", "out.so")
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)


# ---------------------------------------------------------------------------
# The arithmetic of the tensor-core designs of K5 and K7, in plain torch (test
# helpers on no path): 3xTF32 products and the chunkwise mLSTM
# ---------------------------------------------------------------------------
def _tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as K5 and K7 take it on the tensor cores: each operand split
    into hi = tf32(x) and lo = tf32(x - hi), then lo·hi + hi·lo + hi·hi
    (the products of TF32 values are exact in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _attention_with(mm, q, k, v, scale):
    """Causal MHA (B,S,H,hd) with both products through ``mm``, the
    softmax in f32 with the -1e30 mask, as K5 computes it."""
    qt, kt, vt = (torch.tensor(a).permute(0, 2, 1, 3) for a in (q, k, v))
    s = mm(qt * scale, kt.transpose(-1, -2))
    S = s.shape[-1]
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, vt) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).numpy()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0])
    np.testing.assert_array_equal(
        _tf32(x).numpy(),
        np.array([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, 3.0],
                 np.float32))
    y = torch.tensor(np.random.default_rng(0).standard_normal(1000),
                     dtype=torch.float32)
    hi = _tf32(y)
    assert float(((y - hi) / y).abs().max()) <= 2 ** -11
    assert float(((y - hi - _tf32(y - hi)) / y).abs().max()) <= 2 ** -21


@pytest.mark.parametrize("split", ["3xtf32", "tf32"])
@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 128), (2, 96, 2, 64)])
def test_k5_3xtf32_split_holds_2e_5_and_plain_tf32_does_not(split, B, S, H,
                                                            hd):
    """K5's products in 3xTF32 inside causal attention agree with the JAX
    oracle at K5's f32 tolerance, 2e-5; the same attention with plain TF32
    products misses it by far, which is why the kernel splits."""
    q, k, v = _qkv(B, S, S, H, H, hd)
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), n_kv_heads=H), np.float32)
    mm = _mm_3xtf32 if split == "3xtf32" else _mm_tf32
    got = _attention_with(mm, q, k, v, hd ** -0.5)
    err = float(np.abs(got - want).max())
    if split == "3xtf32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert err > 2e-5 * 10, err


def _mlstm_chunkwise(q, k, v, ig, fg, L, mm=torch.matmul):
    """csrc/mlstm.cu's four passes in plain torch, f32 (numpy in, h out):
    the stepwise m and F (summed in double from each chunk start), the
    weighted intra-chunk scores G, the boundary states C and n, and the
    outputs a·sc·Q C^T + G V over max(|n·q|, exp(-m))."""
    B, S, H, hd = q.shape
    sc = hd ** -0.25
    q, k, v = (torch.tensor(a).permute(0, 2, 1, 3) for a in (q, k, v))
    ig, fg = (torch.tensor(a).permute(0, 2, 1) for a in (ig, fg))
    lf = -(torch.clamp(-fg, min=0) + torch.log1p(torch.exp(-fg.abs())))
    M, F = torch.empty_like(ig), torch.empty_like(ig)
    m = torch.full((B, H), -1e30)
    Fd = torch.zeros((B, H), dtype=torch.float64)
    for t in range(S):                       # pass 1: gates
        Fd = (Fd if t % L else 0 * Fd) + lf[..., t].double()
        m = torch.maximum(lf[..., t] + m, ig[..., t])
        M[..., t], F[..., t] = m, Fd.float()
    C = torch.zeros((B, H, hd, hd))
    n = torch.zeros((B, H, hd, 1))
    h = torch.empty((B, H, S, hd))
    for c0 in range(0, S, L):
        sl = slice(c0, min(S, c0 + L))
        Fc, Mc, Ic = F[..., sl], M[..., sl], ig[..., sl]
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        mc = M[..., c0 - 1] if c0 else torch.full((B, H), -1e30)
        n_t = Fc.shape[-1]
        causal = torch.ones(n_t, n_t, dtype=torch.bool).tril()
        W = torch.exp((Fc[..., :, None] - Fc[..., None, :])
                      + (Ic[..., None, :] - Mc[..., :, None]))
        G = torch.where(causal, mm(qc, kc.transpose(-1, -2)) * (sc * sc) * W,
                        0.0)                 # pass 3: intra
        a = torch.exp(Fc + mc[..., None] - Mc)
        nq = a * sc * mm(qc, n)[..., 0] + G.sum(-1)
        den = torch.maximum(nq.abs(), torch.exp(-Mc))
        num = ((a * sc)[..., None] * mm(qc, C.transpose(-1, -2))
               + mm(G, vc))                  # pass 4: outputs
        h[:, :, sl] = num / den[..., None]
        we = torch.exp((Fc[..., -1:] - Fc) + (Ic - Mc[..., -1:])) * sc
        ae = a[..., -1, None, None]          # pass 2: boundary states
        C = ae * C + mm((vc * we[..., None]).transpose(-1, -2), kc)
        n = ae * n + mm((kc * we[..., None]).transpose(-1, -2),
                        torch.ones(n_t, 1))
    return h.permute(0, 2, 1, 3).numpy()


def _mlstm_regime(B, S, H, hd, gates, seed=0):
    """chip_smoke.py's ML_GATES regimes: (ig shift, fg shift, q and k
    drawn >= 0)."""
    ish, fsh, nonneg = {"standard": (0.0, 2.0, False),
                        "negative": (-8.0, -8.0, False),
                        "positive": (8.0, 8.0, True)}[gates]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if nonneg:
        q, k = np.abs(q), np.abs(k)
    ig = (rng.standard_normal((B, S, H)) + ish).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + fsh).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("gates", ["standard", "negative", "positive"])
@pytest.mark.parametrize("hd", [32, 36, 128])
@pytest.mark.parametrize("L", [1, 16, 64, 128])
def test_k7_chunkwise_passes_match_jax_ref(L, hd, gates):
    """K7's chunkwise arithmetic against the JAX oracle at 2e-4, at the
    lengths around chunk boundaries (1, L - 1, L, L + 1, 2L + 3), with its
    products in f32 and, at the largest length, in 3xTF32 as on the card."""
    for S in sorted({1, L - 1, L, L + 1, 2 * L + 3} - {0}):
        xs = _mlstm_regime(1, S, 2, hd, gates, seed=S)
        want, _ = jref.mlstm_ref(*(jnp.asarray(a) for a in xs))
        want = np.asarray(want)
        got = _mlstm_chunkwise(*xs, L)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=f"S={S}")
    got = _mlstm_chunkwise(*xs, L, mm=_mm_3xtf32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                               err_msg=f"S={S} 3xTF32")


@pytest.mark.parametrize("B,S,H,hd,ck", [(1, 64, 2, 32, 32),
                                         (2, 256, 2, 64, 64)])
def test_k7_chunkwise_passes_match_jax_interpret(B, S, H, hd, ck):
    """The same transcription (L = 128, 3xTF32 products) against the
    Pallas kernel in interpret mode, tests/test_kernels.py's sweep, at
    2e-4."""
    xs = _mlstm_inputs(B, S, H, hd)
    jh, _ = jops.mlstm(*(jnp.asarray(a) for a in xs), impl="interpret",
                       chunk=ck)
    np.testing.assert_allclose(_mlstm_chunkwise(*xs, 128, mm=_mm_3xtf32),
                               np.asarray(jh), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# K7: the mLSTM recurrence, plain version against the JAX oracle and kernel
# ---------------------------------------------------------------------------
def _mlstm_inputs(B, S, H, hd, seed=11, f_shift=2.0, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    ig = (rng.standard_normal((B, S, H)) * gate_scale).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) * gate_scale
          + f_shift).astype(np.float32)
    return q, k, v, ig, fg


def _state_np(B, H, hd, seed=12):
    rng = np.random.default_rng(seed)
    return {"C": rng.standard_normal((B, H, hd, hd)).astype(np.float32),
            "n": rng.standard_normal((B, H, hd)).astype(np.float32),
            "m": rng.standard_normal((B, H)).astype(np.float32)}


@pytest.mark.parametrize("carried", [False, True])
def test_k7_mlstm_plain_matches_jax_ref(carried):
    """h and the final (C, n, m) at 1e-5, from the zero state (m = -inf)
    and from a carried state, which the port updates in place."""
    xs = _mlstm_inputs(2, 24, 3, 16)
    st = _state_np(2, 3, 16) if carried else None
    jh, jst = jref.mlstm_ref(*(jnp.asarray(a) for a in xs),
                             state=None if st is None else
                             {k: jnp.asarray(a) for k, a in st.items()})
    tst = None if st is None else {k: torch.tensor(a) for k, a in st.items()}
    th, tst2 = tref.mlstm_ref(*(torch.tensor(a) for a in xs), state=tst)
    if carried:
        assert tst2 is tst                    # updated in place
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(tst2[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,hd,ck", [
    (1, 64, 2, 32, 32),
    (2, 128, 4, 64, 64),
])
def test_k7_mlstm_plain_matches_jax_interpret(B, S, H, hd, ck):
    """tests/test_kernels.py's sweep: the Pallas kernel in interpret mode
    against the port's ``ops.mlstm`` on CPU tensors, at 2e-4."""
    xs = _mlstm_inputs(B, S, H, hd)
    jh, _ = jops.mlstm(*(jnp.asarray(a) for a in xs), impl="interpret",
                       chunk=ck)
    th, none = tops.mlstm(*(torch.tensor(a) for a in xs))
    assert none is None and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)


def test_k7_wrapper_refuses_cpu_tensors_and_grad():
    """No fallback: K7's wrapper takes CUDA tensors only, and it is
    forward only."""
    from repro_torch.kernels import mlstm as tml
    xs = [torch.tensor(a) for a in _mlstm_inputs(1, 5, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        tml.mlstm_fwd(*xs)
    qg = xs[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        tml.mlstm_fwd(qg, *xs[1:])
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tml.mlstm_fwd(qg, *xs[1:])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tml.mlstm_fwd(xs[0].double(), *xs[1:])
    h, _ = tops.mlstm(*xs)
    assert h.shape == (1, 5, 2, 8)
    with pytest.raises(ValueError, match="one device"):
        tops.mlstm(xs[0], xs[1].to("meta"), *xs[2:])
    assert tops.launch_counts()["mlstm"] == 0


# ---------------------------------------------------------------------------
# K6: the Mamba selective scan, plain version against the JAX oracle and
# kernel
# ---------------------------------------------------------------------------
def _scan_inputs(B, S, di, st, seed=21, regime="jax"):
    """xc, Bm, Cm ~ N(0, 1), D = 1, and dt, A by ``regime``: "jax" as
    tests/test_kernels.py draws them (dt = softplus(N(0, 1)) * 0.1,
    A = -exp(0.3 N(0, 1))); "mamba_init" as ``models/mamba.py`` initialises
    a layer (A = -[1..st], dt = softplus(N(0, 1) - 4.6)); "strong" decay
    (A = -[1..st], dt ~ U(0, 3), so |dt·A| reaches 48)."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, S, di)).astype(np.float32)
    n = rng.standard_normal((B, S, di))
    if regime == "jax":
        dt = np.logaddexp(n, 0.0) * 0.1
    elif regime == "mamba_init":
        dt = np.logaddexp(n - 4.6, 0.0)
    else:
        dt = rng.uniform(0.0, 3.0, (B, S, di))
    Bm = rng.standard_normal((B, S, st)).astype(np.float32)
    Cm = rng.standard_normal((B, S, st)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, st)) * 0.3) if regime == "jax"
         else -np.broadcast_to(np.arange(1.0, st + 1), (di, st)))
    D = np.ones(di, np.float32)
    return (xc, dt.astype(np.float32), Bm, Cm, A.astype(np.float32), D)


@pytest.mark.parametrize("carried", [False, True])
def test_k6_selective_scan_plain_matches_jax_ref(carried):
    """y and the final state at 1e-5, from the zero state and from a
    carried one, which the port updates in place."""
    xs = _scan_inputs(2, 40, 24, 8)
    h0 = (np.random.default_rng(22).standard_normal((2, 24, 8))
          .astype(np.float32) if carried else None)
    jy, jh = jref.selective_scan_ref(*(jnp.asarray(a) for a in xs),
                                     None if h0 is None else jnp.asarray(h0))
    th0 = None if h0 is None else torch.tensor(h0)
    ty, th = tref.selective_scan_ref(*(torch.tensor(a) for a in xs), th0)
    if carried:
        assert th is th0                      # updated in place
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,S,di,st,bd,ck", [
    (1, 64, 128, 8, 128, 32),
    (2, 128, 256, 16, 128, 64),
    (1, 256, 128, 4, 64, 256),
])
def test_k6_selective_scan_plain_matches_jax_interpret(B, S, di, st, bd,
                                                       ck):
    """tests/test_kernels.py's sweep: the Pallas kernel in interpret mode
    against the port's ``ops.selective_scan`` on CPU tensors, at 1e-5."""
    xs = _scan_inputs(B, S, di, st)
    jy, jh = jops.selective_scan(*(jnp.asarray(a) for a in xs),
                                 impl="interpret", block_d=bd, chunk=ck)
    ty, th = tops.selective_scan(*(torch.tensor(a) for a in xs))
    assert ty.shape == (B, S, di) and th.shape == (B, di, st)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_k6_wrapper_refuses_cpu_tensors_and_grad():
    """No fallback: K6's wrapper takes CUDA tensors only, and it is
    forward only."""
    from repro_torch.kernels import selective_scan as tss
    xs = [torch.tensor(a) for a in _scan_inputs(1, 5, 16, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan_fwd(*xs)
    xg = xs[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        tss.selective_scan_fwd(xg, *xs[1:])
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan_fwd(xg, *xs[1:])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tss.selective_scan_fwd(xs[0].double(), *xs[1:])
    y, h = tops.selective_scan(*xs)
    assert y.shape == (1, 5, 16) and h.shape == (1, 16, 4)
    with pytest.raises(ValueError, match="one device"):
        tops.selective_scan(xs[0], xs[1].to("meta"), *xs[2:])
    assert tops.launch_counts()["selective_scan"] == 0


# ---------------------------------------------------------------------------
# K6's arithmetic (csrc/selective_scan.cu) in plain torch (test helpers on no
# path): prescaled exp2 on the SFU, fused multiply-adds, y_t in one chain
# ---------------------------------------------------------------------------
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma32(a, b, c):
    """fmaf in f32: the product and sum in float64, rounded once (a product
    of two f32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _ex2_sfu(z, ulps=0):
    """``ex2.approx.ftz.f32`` on f32 tensors: exp2 moved ``ulps`` ulps
    (toward +inf if positive, toward 0 if negative) to stand for its error,
    taken as at most 2 ulp (the CUDA C++ Programming Guide's bound for
    ``exp2f``), then results below 2^-126 flushed to 0. Only the card tests
    hold the instruction itself."""
    r = torch.exp2(z)
    to = torch.tensor(float("inf") if ulps > 0 else 0.0)
    for _ in range(abs(ulps)):
        r = torch.nextafter(r, to)
    return torch.where(r < 2.0 ** -126, torch.zeros_like(r), r)


def _scan_kernel_order(xc, dt, Bm, Cm, A, D, ulps=0):
    """K6's arithmetic on numpy inputs -> (y, h) in f32: a2 = A·log2(e);
    per step, per state in order, dA = ex2(dt·a2[s]) (off by ``ulps``),
    h = fmaf(dA, h, (dt·B)·x), acc = fmaf(h, C, acc); y = fmaf(x, D,
    acc)."""
    xc, dt, Bm, Cm, A, D = (torch.tensor(a) for a in (xc, dt, Bm, Cm, A, D))
    B, S, di = xc.shape
    st = A.shape[-1]
    a2 = A * _LOG2E
    h = torch.zeros((B, di, st))
    y = torch.empty((B, S, di))
    for t in range(S):
        x, d = xc[:, t, :, None], dt[:, t, :, None]
        dA = _ex2_sfu(d * a2, ulps)
        h = _fma32(dA, h, (d * Bm[:, t, None, :]) * x)
        acc = torch.zeros((B, di))
        for s in range(st):
            acc = _fma32(h[..., s], Cm[:, t, None, s], acc)
        y[:, t] = _fma32(x[..., 0], D, acc)
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("ulps", [0, 2, -2])
@pytest.mark.parametrize("regime", ["jax", "mamba_init", "strong"])
@pytest.mark.parametrize("B,S,di,st", [(2, 300, 24, 16), (1, 97, 16, 8),
                                       (2, 64, 8, 4)])
def test_k6_kernel_order_matches_jax_ref(ulps, regime, B, S, di, st):
    """K6's order of operations holds the JAX oracle at K6's 1e-5, y and
    the final state, with the SFU's exp2 exact and with every exp off by
    its 2-ulp bound the same way (errors that add up along the sequence
    instead of cancelling)."""
    xs = _scan_inputs(B, S, di, st, seed=23, regime=regime)
    jy, jh = jref.selective_scan_ref(*(jnp.asarray(a) for a in xs))
    ty, th = _scan_kernel_order(*xs, ulps)
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=1e-5, atol=1e-5)
