"""Wire kernels K1-K4 of the PyTorch port against the JAX package.

CPU half: the port's plain versions (``repro_torch/kernels/ref.py``) are
held against the JAX oracles (``repro/kernels/ref.py``, ``impl="ref"``)
and the Pallas kernel bodies run in interpret mode (``impl="interpret"``),
as ``tests/test_kernels.py`` runs them. Packed payloads are bit-exact;
8/4-bit scales are exact against the oracle (the interpret-mode kernel's
``amax / qmax`` may differ from it by one f32 ULP, and the 1-bit mean's
summation order differs everywhere, hence rtol 1e-6 there).

Card half (marked ``gpu``, skipped without CUDA): each hand-written CUDA
kernel against the plain version on the same CUDA inputs.
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
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the wire kernels build with nvcc "
                    "for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_gpu_k1_k2_kernels_match_plain(cuda, bits, shape):
    x = torch.tensor(_x(shape), device=cuda)
    before = tops.launch_counts()
    q_k, s_k, shp = tqz.quantize_blockwise_fwd(x, bits=bits)
    q_p, s_p, _ = tref.quantize_blockwise_ref(x, bits=bits)
    nb = q_p.shape[0]
    assert q_k.shape[0] % ROWS == 0
    assert torch.equal(q_k[:nb], q_p)
    if bits == 1:
        torch.testing.assert_close(s_k[:nb], s_p, rtol=1e-6, atol=0)
    else:
        assert torch.equal(s_k[:nb], s_p)
    d_k = tqz.dequantize_blockwise_fwd(q_p, s_p, shp, bits=bits)
    assert torch.equal(d_k, tref.dequantize_blockwise_ref(q_p, s_p, shp,
                                                          bits=bits))
    after = tops.launch_counts()
    assert after["wire_quantize"] == before["wire_quantize"] + 1
    assert after["wire_dequantize"] == before["wire_dequantize"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("K,n", BUFS)
def test_gpu_k3_k4_kernels_match_plain(cuda, bits, K, n):
    buf = torch.tensor(_x((K, n), seed=2, scale=3.0), device=cuda)
    res = torch.tensor(_x((K, n), seed=4, scale=0.1), device=cuda)
    torch.testing.assert_close(tcomm.quant_avg_dequant_fwd(buf, bits=bits),
                               tref.quant_avg_dequant_ref(buf, bits=bits),
                               **_tol(bits))
    m_k, e_k = tcomm.quant_avg_dequant_ef_fwd(buf, res.clone(), bits=bits)
    m_p, e_p = tref.quant_avg_dequant_ef_ref(buf, res.clone(), bits=bits)
    torch.testing.assert_close(m_k, m_p, **_tol(bits))
    torch.testing.assert_close(e_k, e_p, **_tol(bits))
    torch.cuda.synchronize()
