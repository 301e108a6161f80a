"""On the card: each hand-written CUDA kernel (K1-K8) against its plain
PyTorch version on the same CUDA inputs, at the JAX suite's tolerances
(tests/test_kernels.py), and the MoE FFN on the card under the sync guard
against the same call on the CPU. Every test is marked ``gpu`` and skips without a
card; the file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import comm as tcomm
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tqz
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantize import ROWS

SHAPES = [(1000, 37), (256,), (3 * 256 + 100,), (8, 8, 8)]
BUFS = [(1, 8 * 256), (3, 16 * 256), (5, 8 * 256 + 300)]


def _x(shape, seed=0, scale=5.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tol(bits):
    return ({"rtol": 1e-7, "atol": 1e-6} if bits == 8
            else {"rtol": 2e-6, "atol": 2e-6})


def _qkv(B, Sq, Sk, H, KV, hd, hd_v):
    return (_x((B, Sq, H, hd), 7, 1.0), _x((B, Sk, KV, hd), 8, 1.0),
            _x((B, Sk, KV, hd_v), 9, 1.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for "
                    "sm_90a)")
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,hd_v,window", [
    (1, 128, 128, 4, 4, 32, 32, 0),       # MHA
    (2, 256, 256, 8, 2, 64, 64, 0),       # GQA
    (1, 128, 128, 4, 1, 32, 32, 0),       # MQA
    (2, 200, 200, 4, 2, 128, 128, 0),     # tails: 200 = 3 x 64 + 8
    (1, 77, 333, 4, 2, 128, 96, 0),       # Sq < Sk, hd_v != hd, odd
    (1, 256, 256, 4, 2, 32, 32, 32),      # window
    (2, 150, 300, 6, 3, 16, 16, 100),     # window, Sq < Sk, odd
    # one below and one above the kernel's tiles (128 rows of one GQA
    # group a block, 64-key tiles), GQA ratios 1, 2 and 4, hd_v != hd
    (1, 127, 127, 4, 4, 64, 64, 0),
    (1, 129, 129, 4, 4, 64, 48, 0),
    (2, 63, 63, 8, 4, 64, 64, 0),
    (2, 65, 129, 8, 4, 128, 96, 0),
    (1, 31, 65, 8, 2, 32, 32, 0),
    (1, 33, 63, 8, 2, 128, 64, 0),
])
def test_gpu_k5_matches_plain(cuda, dtype, B, Sq, Sk, H, KV, hd, hd_v,
                              window):
    q, k, v = (torch.tensor(a, device=cuda).to(dtype)
               for a in _qkv(B, Sq, Sk, H, KV, hd, hd_v))
    before = tfa.flash_attention_fwd.launches
    got = tfa.flash_attention_fwd(q, k, v, n_kv_heads=KV, window=window)
    want = tref.flash_attention_ref(q, k, v, n_kv_heads=KV, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert got.dtype == dtype
    assert tfa.flash_attention_fwd.launches == before + 1
    torch.cuda.synchronize()



def _k8(dev, B, S, H, KV, hd, seed=21):
    """q (B,1,H,hd) and a cache (B,S,KV,hd) of keys and values, unit
    normals."""
    return (torch.tensor(_x((B, 1, H, hd), seed, 1.0), device=dev),
            torch.tensor(_x((B, S, KV, hd), seed + 1, 1.0), device=dev),
            torch.tensor(_x((B, S, KV, hd), seed + 2, 1.0), device=dev))


def _k8_check(q, k, v, pos, window, tol=1e-5):
    """K8 against its plain version at ``tol``; one launch counted."""
    before = tda.decode_attention_fwd.launches
    kw = {"window": window, "softmax_scale": q.shape[-1] ** -0.5}
    got = tda.decode_attention_fwd(q, k, v, pos, **kw)
    want = tref.decode_attention_ref(q, k, v, pos, **kw)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert tda.decode_attention_fwd.launches == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_gpu_k8_matches_plain(cuda, G, hd):
    """K8 against its plain version at 1e-5: B odd, S = 100 (not a multiple
    of the 64-slot chunk), pos at 0, at the first chunk's last slot, the
    next chunk's first and S - 1, as int32 and int64."""
    KV = 2
    q, k, v = _k8(cuda, 3, 100, G * KV, KV, hd, seed=G * 1000 + hd)
    for p in (0, 63, 64, 99):
        for dt in (torch.int32, torch.int64):
            _k8_check(q, k, v, torch.tensor(p, dtype=dt, device=cuda), 0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 100])
def test_gpu_k8_sliding_window_ring(cuda, S):
    """A sliding window's ring of S slots: before it wraps only the slots
    up to pos are read, after it (pos >= S) every slot."""
    q, k, v = _k8(cuda, 3, S, 8, 2, 128, seed=S)
    for p in (S - 2, S - 1, S, S + 17, 5 * S + 3):
        _k8_check(q, k, v, torch.tensor(p, dtype=torch.int32, device=cuda),
                  S)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_k8_captured_replays_follow_pos(cuda):
    """K8 captured once in a CUDA graph reads pos from the card: replays
    with pos changed between them, under the sync guard, equal eager
    launches at those positions bit for bit (the same inputs give the same
    bits), and the plain version at 1e-5."""
    B, S, H, KV, hd = 5, 200, 16, 8, 128
    q, k, v = _k8(cuda, B, S, H, KV, hd)
    kw = {"window": 0, "softmax_scale": hd ** -0.5}
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # build, first launch
        tda.decode_attention_fwd(q, k, v, pos, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tda.decode_attention_fwd(q, k, v, pos, **kw)
    order = (0, 63, 64, 199, 127, 63, 0)
    replays = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p in order:
            pos.fill_(p)
            graph.replay()
            replays.append(out.clone())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for p, got in zip(order, replays):
        eager = _k8_check(q, k, v, torch.tensor(p, dtype=torch.int32,
                                                device=cuda), 0)
        assert torch.equal(got, eager), p
    assert not torch.equal(replays[0], replays[3])
    torch.cuda.synchronize()


# gate regimes: (ig shift, fg shift, q and k drawn >= 0)
MLSTM_GATES = {"standard": (0.0, 2.0, False),    # tests/test_kernels.py's
               "negative": (-8.0, -8.0, False),
               "positive": (8.0, 8.0, True)}


def mlstm_inputs(B, S, H, hd, gates, dev, dtype, seed=0):
    """q, k, v in ``dtype`` and f32 gates N(shift, 1). With strongly
    positive input gates exp(-m) no longer bounds the denominator, and
    |n . q| of random-sign q and k cancels: there f32 results of any
    summation order differ from the exact ones by more than 2e-4 (up to
    20x, against a float64 recurrence on the CPU), so that regime draws
    q, k >= 0 and keeps n . q away from zero."""
    ish, fsh, nonneg = MLSTM_GATES[gates]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)) for _ in range(3))
    if nonneg:
        q, k = np.abs(q), np.abs(k)
    ig = rng.standard_normal((B, S, H)) + ish
    fg = rng.standard_normal((B, S, H)) + fsh
    return (*(torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)
              for a in (q, k, v)),
            *(torch.tensor(a, dtype=torch.float32, device=dev)
              for a in (ig, fg)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 37, 300])
@pytest.mark.parametrize("hd", [64, 128, 1024])
@pytest.mark.parametrize("gates", list(MLSTM_GATES))
def test_gpu_k7_matches_plain(cuda, dtype, S, hd, gates):
    """K7 against ``ref.mlstm_ref`` on the same CUDA inputs at 2e-4 (the
    JAX suite's tolerance for K7), with f32 and bf16 gates. bf16 q/k/v
    are widened the same way by both, and h is f32."""
    from repro_torch.kernels import mlstm as tml
    B, H = 2, 3
    q, k, v, ig, fg = mlstm_inputs(B, S, H, hd, gates, cuda, dtype)
    before = tml.mlstm_fwd.launches
    got = tml.mlstm_fwd(q, k, v, ig, fg)
    want, _ = tref.mlstm_ref(q, k, v, ig, fg)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert tml.mlstm_fwd.launches == before + 1
    got16 = tml.mlstm_fwd(q, k, v, ig.bfloat16(), fg.bfloat16())
    want16, _ = tref.mlstm_ref(q, k, v, ig.bfloat16(), fg.bfloat16())
    torch.testing.assert_close(got16, want16, rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [127, 128, 129, 259])
@pytest.mark.parametrize("hd", [36, 100])
@pytest.mark.parametrize("gates", list(MLSTM_GATES))
def test_gpu_k7_chunk_boundaries_match_plain(cuda, dtype, S, hd, gates):
    """K7 runs in chunks of 128 steps: lengths one below, at and one above
    a chunk and two chunks and a tail, at head sizes that are not
    multiples of the products' depth of 8, against ``ref.mlstm_ref`` at
    2e-4, with f32 and bf16 gates."""
    from repro_torch.kernels import mlstm as tml
    q, k, v, ig, fg = mlstm_inputs(1, S, 2, hd, gates, cuda, dtype, seed=S)
    for a, b in ((ig, fg), (ig.bfloat16(), fg.bfloat16())):
        got = tml.mlstm_fwd(q, k, v, a, b)
        want, _ = tref.mlstm_ref(q, k, v, a, b)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()


def scan_inputs(B, S, di, st, dev, x_dtype, seed=0, regime="jax"):
    """K6's inputs: xc, Bm, Cm ~ N(0, 1), D = 1, and dt, A by ``regime``:
    "jax" as tests/test_kernels.py draws them (dt = softplus(N(0, 1)) *
    0.1, A = -exp(0.3 N(0, 1))); "mamba_init" as ``models/mamba.py``
    initialises a layer (A = -[1..st], dt = softplus(N(0, 1) - 4.6));
    "strong" decay (A = -[1..st], dt ~ U(0, 3), |dt·A| up to 48). xc in
    ``x_dtype``, the rest f32."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, S, di))
    n = rng.standard_normal((B, S, di))
    dt = {"jax": lambda: np.logaddexp(n, 0.0) * 0.1,
          "mamba_init": lambda: np.logaddexp(n - 4.6, 0.0),
          "strong": lambda: rng.uniform(0.0, 3.0, (B, S, di))}[regime]()
    Bm = rng.standard_normal((B, S, st))
    Cm = rng.standard_normal((B, S, st))
    A = (-np.exp(rng.standard_normal((di, st)) * 0.3) if regime == "jax"
         else -np.broadcast_to(np.arange(1.0, st + 1), (di, st)))
    f32 = [torch.tensor(a, dtype=torch.float32, device=dev)
           for a in (xc, dt, Bm, Cm, A, np.ones(di))]
    return (f32[0].to(x_dtype), *f32[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["jax", "mamba_init", "strong"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,st", [
    (1, 64, 128, 8), (2, 128, 256, 16), (1, 256, 128, 4),   # JAX sweep
    (2, 1, 128, 16),                                        # one step
    (2, 37, 200, 8),                                        # ragged di, S
    (1, 19, 8192, 16),                                      # jamba's di
    (2, 16, 64, 16), (1, 17, 64, 16),                       # K6's chunk
])
def test_gpu_k6_matches_plain(cuda, regime, x_dtype, B, S, di, st):
    """K6 against ``ref.selective_scan_ref`` on the same CUDA inputs at
    1e-5 (the JAX suite's tolerance for K6): y and the final state, with
    dt and A drawn as the JAX suite draws them, as Mamba initialises them
    and with strong decay."""
    from repro_torch.kernels import selective_scan as tss
    xs = scan_inputs(B, S, di, st, cuda, x_dtype, regime=regime)
    before = tss.selective_scan_fwd.launches
    y, h = tss.selective_scan_fwd(*xs)
    wy, wh = tref.selective_scan_ref(*xs)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, st)
    torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, wh, rtol=1e-5, atol=1e-5)
    assert tss.selective_scan_fwd.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_k6_takes_f32_dt_only(cuda):
    """dt is the softplus output, f32 in ``models.mamba``: K6 reads it as
    f32 and refuses any other dtype before launching."""
    from repro_torch.kernels import selective_scan as tss
    xs = list(scan_inputs(1, 8, 128, 8, cuda, torch.float32))
    xs[1] = xs[1].to(torch.bfloat16)
    before = tss.selective_scan_fwd.launches
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        tss.selective_scan_fwd(*xs)
    assert tss.selective_scan_fwd.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(8, 1), (4, 64)])
def test_gpu_moe_apply_under_sync_guard_matches_cpu(cuda, B, S):
    """``moe_apply`` on the card asks the host nothing (it runs under
    ``set_sync_debug_mode("error")``) and equals the same call on the CPU
    at 1e-5: routing, drops (capacity factor 0.5 drops tokens at 4 x 64),
    the scatter and the combine."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as tmoe
    cfg = get_smoke_config("jamba-v0.1-52b").with_(capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, cfg, torch.float32)
    x = torch.tensor(_x((B, S, cfg.d_model), seed=3, scale=1.0))
    want_y, want_aux = tmoe.moe_apply(p, x, cfg)
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = tmoe.moe_apply(pc, xc, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(y.cpu(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 64])
def test_gpu_moe_dense_layer_under_sync_guard_matches_cpu(cuda, S):
    """One ``gqa:moe_dense`` layer (arctic's smoke config, K5 on the card
    at S = 64) under the sync guard against the same call on the CPU at
    1e-5: the MoE's output plus the dense FFN's, and the aux loss."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("arctic-480b")
    gen = torch.Generator().manual_seed(0)
    p = tr.layer_init(gen, "gqa:moe_dense", cfg, torch.float32)
    x = torch.tensor(_x((4, S, cfg.d_model), seed=5, scale=1.0))
    pos = torch.arange(S, dtype=torch.int32).expand(4, S)
    want_y, want_aux = tr.layer_apply(p, "gqa:moe_dense", x, cfg, pos)
    pc = tree_map(lambda t: t.to(cuda), p)
    xc, posc = x.to(cuda), pos.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = tr.layer_apply(pc, "gqa:moe_dense", xc, cfg, posc,
                                "kernel")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(y.cpu(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The fused round engine on the card: every round as replays of CUDA graphs
# captured once (core/graphs.py), against the python engine's eager rounds.
# ---------------------------------------------------------------------------
LOG_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _fused_setup():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import build_data
    from repro_torch.models import transformer as tr
    cfg = get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, segments=((("gqa:dense",), 1),))
    data = build_data(cfg, 3, 4, 16, 48, seed=0)
    return cfg, data, tr.init_params(0, cfg, torch.float32, device="cpu")


def _learner(dev, engine, *, codec=("exact", {}), T0=1, eps=1e-6,
             rule="ile", schedule="clr", optimizer="sgd", loss=None,
             chunk=32, max_rounds=3):
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import make_loss_fn
    cfg, data, params = _fused_setup()
    ccfg = CoLearnConfig(n_participants=3, T0=T0, eta0=0.05, epsilon=eps,
                         epochs_rule=rule, max_rounds=max_rounds)
    learner = CoLearner(
        ccfg, loss or make_loss_fn(cfg), optimizer_name=optimizer,
        codec=api.get_codec(codec[0], **codec[1]),
        round_engine=(api.FusedEngine(chunk) if engine == "fused"
                      else "python"),
        schedule=schedule, device=dev)
    return learner, learner.init(params), data


def _rounds(learner, state, data, n):
    from repro_torch.launch.train import epoch_batches_fn
    batches = epoch_batches_fn(data, learner.device, 2)
    for _ in range(n):
        state = learner.run_round(state, batches)
    return state


def _logs_close(a, b):
    assert [x.T for x in a["log"]] == [x.T for x in b["log"]]
    for x, y in zip(a["log"], b["log"]):
        assert x.comm_bytes == y.comm_bytes
        np.testing.assert_allclose(y.local_losses, x.local_losses, **LOG_TOL)
        # the fused rate is f32 on the device, the python engine's a host
        # double: 1 + cos near the cosine's tail cancels to ~1e-6 (rel)
        np.testing.assert_allclose([y.lr_first, y.lr_last],
                                   [x.lr_first, x.lr_last], rtol=1e-5,
                                   atol=1e-8)
        if np.isinf(x.rel_change):
            assert np.isinf(y.rel_change)
        else:
            np.testing.assert_allclose(y.rel_change, x.rel_change, **LOG_TOL)


def _param_diff(a, b):
    from repro_torch.tree import leaves
    return max(float((x - y.to(x.device)).abs().max())
               for x, y in zip(leaves(a["params"]), leaves(b["params"])))


def _quantum(stacked, bits):
    """Largest per-row wire scale of the flat buffer over K (rows of zero
    padding excluded): one code step of the quantizing codecs."""
    from repro_torch.core import flatbuf
    from repro_torch.tree import tree_map
    cpu = tree_map(lambda t: t.cpu(), stacked)
    buf = flatbuf.flatten(cpu, flatbuf.make_layout(cpu))
    live = buf.reshape(-1, 256).abs().amax(1) > 0
    scale = tref.quantize_blockwise_ref(buf, bits=bits)[1]
    return float(scale[live].max()) / buf.shape[0]


FUSED_CASES = [
    (("exact", {}), "sgd"), (("exact", {}), "adamw"),
    (("exact", {}), "momentum"), (("fused", {}), "sgd"),
    (("leafwise", {}), "sgd"),
    (("fused", {"bits": 4, "error_feedback": True}), "sgd")]


@pytest.mark.gpu
@pytest.mark.parametrize("codec,optimizer", FUSED_CASES)
def test_gpu_fused_rounds_match_python(cuda, codec, optimizer):
    """Captured rounds (a round graph per T; ε = 0.5 doubles T after the
    second round except under AdamW) equal the python
    engine's eager rounds on the card: logs at 1e-5, params at 1e-5 for
    the exact codec and within one wire quantum for the quantizing ones
    (the rate is f32 on the device, a host double in the python engine:
    one ulp may move a value across a rounding boundary)."""
    runs = {}
    for engine in ("python", "fused"):
        learner, state, data = _learner(cuda, engine, codec=codec, eps=0.5,
                                        optimizer=optimizer)
        runs[engine] = (learner, _rounds(learner, state, data, 3))
    (_, sp), (fl, sf) = runs["python"], runs["fused"]
    _logs_close(sp, sf)
    # a round graph per distinct T; every round but the first replays
    assert fl._fused_round.captures == len({x.T for x in sf["log"]})
    assert fl._fused_round.replays == 2
    bits = codec[1].get("bits", 8)
    tol = 1e-5 if codec[0] == "exact" else _quantum(sp["params"], bits)
    assert _param_diff(sp, sf) <= tol
    if codec[1].get("error_feedback"):
        assert float((sp["residual"] - sf["residual"]).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [("exact", {}), ("fused", {}), (
    "fused", {"bits": 4, "error_feedback": True})])
def test_gpu_captured_rounds_equal_uncaptured(cuda, codec):
    """The same fused functions on the card, replayed from graphs and run
    eagerly (the graph set told it is not on the card, as on the CPU):
    logs and params at 1e-5."""
    runs = []
    for captured in (True, False):
        learner, state, data = _learner(cuda, "fused", codec=codec,
                                        rule="fle")
        learner._runner.graphs.on_cuda = captured
        runs.append((learner, _rounds(learner, state, data, 3)))
    (cl, cs), (ul, us) = runs
    assert cl._fused_round.replays == 2 and ul._fused_round.replays == 0
    _logs_close(us, cs)
    assert _param_diff(us, cs) <= 1e-5
    if codec[1].get("error_feedback"):
        assert float((us["residual"] - cs["residual"]).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_gpu_fused_restart_participant_between_replays(cuda):
    """``restart_participant`` writes the state in place: the next round
    replays the same graph (no capture) and equals the python engine
    doing the same."""
    from repro_torch.tree import leaves
    runs = {}
    for engine in ("python", "fused"):
        learner, state, data = _learner(
            cuda, engine, codec=("fused", {"bits": 4,
                                           "error_feedback": True}),
            rule="fle")
        state = _rounds(learner, state, data, 2)
        with torch.no_grad():
            for t in leaves(state["params"]):
                t[1].add_(1.0)                       # a failed participant
        learner.restart_participant(state, 1)
        runs[engine] = (learner, _rounds(learner, state, data, 1))
    (_, sp), (fl, sf) = runs["python"], runs["fused"]
    assert (fl._fused_round.captures, fl._fused_round.replays) == (1, 2)
    _logs_close(sp, sf)
    assert _param_diff(sp, sf) <= _quantum(sp["params"], 4)


@pytest.mark.gpu
def test_gpu_fused_chunked_first_round_matches_python(cuda):
    """T0 = 5 over chunks of 2: the first key is a chunk graph (its eager
    run is the set's warm-up) and the finalize is captured without one."""
    runs = {}
    for engine in ("python", "fused"):
        learner, state, data = _learner(
            cuda, engine, codec=("fused", {}), T0=5, rule="fle", chunk=2)
        runs[engine] = (learner, _rounds(learner, state, data, 2))
    (_, sp), (fl, sf) = runs["python"], runs["fused"]
    _logs_close(sp, sf)
    assert _param_diff(sp, sf) <= _quantum(sp["params"], 8)
    assert (fl._fused_epochs.captures, fl._fused_finalize.captures,
            fl._fused_round.captures) == (2, 1, 0)      # chunk lengths 2, 1


@pytest.mark.gpu
def test_gpu_fused_captures_stay_flat(cuda):
    """T 2 -> 2 -> 4 -> 8 with chunk=2 captures the round graph once, the
    chunk graph once and the finalize once; the budget updates with every
    doubling; CLR -> ELR -> WarmupCLR -> cosine swaps capture nothing new.
    The python engine runs the same sequence: the logs agree."""
    from repro_torch.core import api
    runs = {}
    for engine in ("python", "fused"):
        learner, state, data = _learner(cuda, engine, T0=2, eps=1e9,
                                        chunk=2, max_rounds=8)
        state = _rounds(learner, state, data, 4)
        if engine == "fused":
            counts = (learner._fused_round.captures,
                      learner._fused_epochs.captures,
                      learner._fused_finalize.captures)
            assert counts == (1, 1, 1)
        learner.set_sync_policy("fle")
        for spec in ("elr", api.WarmupCLR(0.05, warmup_rounds=3),
                     "cosine"):
            learner.set_schedule(spec)
            state = _rounds(learner, state, data, 1)
        runs[engine] = (learner, state)
    (_, sp), (fl, sf) = runs["python"], runs["fused"]
    assert [x.T for x in sf["log"]] == [2, 2, 4, 8, 16, 16, 16]
    assert (fl._fused_round.captures, fl._fused_epochs.captures,
            fl._fused_finalize.captures) == (1, 1, 1)
    assert fl._runner.graphs.captures == 3
    _logs_close(sp, sf)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [("fused", {}), ("leafwise", {}), (
    "fused", {"bits": 4, "error_feedback": True})])
def test_gpu_fused_launch_counts_equal_launches(cuda, codec):
    """Replays add the launches each graph recorded at capture, so the
    counters over three rounds (one eager and capturing, two replays)
    equal the python engine's eager launches."""
    counts = {}
    for engine in ("python", "fused"):
        learner, state, data = _learner(cuda, engine, codec=codec)
        tops.reset_launch_counts()
        _rounds(learner, state, data, 3)
        torch.cuda.synchronize()
        counts[engine] = tops.launch_counts()
    assert counts["fused"] == counts["python"]
    assert sum(counts["fused"].values()) > 0
    if codec == ("fused", {}):
        assert counts["fused"]["wire_quant_avg_dequant"] == 3


@pytest.mark.gpu
def test_gpu_fused_window_is_sync_free(cuda):
    """Replayed rounds run under ``set_sync_debug_mode("error")`` from the
    end of staging to the one fetch; a host sync injected into that window
    raises, and the guard is lifted again afterwards."""
    learner, state, data = _learner(cuda, "fused", codec=("fused", {}))
    state = _rounds(learner, state, data, 2)           # capture, replay
    runner = learner._runner
    captured = runner._round

    def leaky(*args):
        out = captured(*args)
        float(out[2])                                   # a host sync
        return out
    runner._round = leaky
    with pytest.raises(RuntimeError, match="synchroniz"):
        _rounds(learner, state, data, 1)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_gpu_fused_reinit_recaptures(cuda):
    """A new ``learner.init`` moves the state's storage: the round graph is
    captured again (never replayed on the old addresses) and the new run
    equals the first one; the old state, run again, recaptures too."""
    learner, s1, data = _learner(cuda, "fused")
    s1 = _rounds(learner, s1, data, 2)
    _, _, params = _fused_setup()
    s2 = _rounds(learner, learner.init(params), data, 2)
    assert learner._fused_round.captures == 2
    _logs_close(s1, s2)
    assert _param_diff(s1, s2) <= 1e-5
    _rounds(learner, s1, data, 1)
    assert learner._fused_round.captures == 3


@pytest.mark.gpu
def test_gpu_fused_capture_failure_raises(cuda):
    """A host transfer inside the captured work makes the capture fail,
    and the round raises: there is no eager fallback. The caller's stream
    and the sync guard are restored."""
    from repro_torch.launch.train import make_loss_fn
    cfg, _, _ = _fused_setup()
    inner = make_loss_fn(cfg)
    calls = [0]

    def loss(params, batch):
        calls[0] += 1
        if calls[0] > 6:                     # past the eager warm-up round
            torch.tensor([1.0], device=batch[0].device)
        return inner(params, batch)
    learner, state, data = _learner(cuda, "fused", loss=loss)
    with pytest.raises(RuntimeError):
        _rounds(learner, state, data, 1)
    assert calls[0] > 6
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------------
# The serving loop's decode step and the sLSTM recurrence as captured CUDA
# graphs (serving/loop.py, models/xlstm.py slstm_scan), against the same
# work run eagerly on the card.
# ---------------------------------------------------------------------------
# deepseek's loop decodes over the MLA latent cache, arctic's through
# the MoE beside a dense FFN
SERVE_ARCHS = ["internlm2-1.8b", "xlstm-1.3b", "jamba-v0.1-52b",
               "deepseek-v3-671b", "arctic-480b", "qwen1.5-32b"]


def _serve_setup(dev, arch, seed=0):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tr
    cfg = get_smoke_config(arch)
    prompts = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 6)), device=dev)
    return cfg, tr.init_params(seed, cfg, torch.float32, device=dev), prompts


def _eager_tokens(cfg, params, prompts, new, max_seq):
    """Greedy tokens of an eager ``decode_step`` loop on a fresh cache."""
    from repro_torch.models import transformer as tr
    B, P = prompts.shape
    cache = tr.init_cache(cfg, B, max_seq, torch.float32, prompts.device)
    pos = torch.arange(max_seq, dtype=torch.int32, device=prompts.device)
    for t in range(P):
        logits, _ = tr.decode_step(params, cfg, cache, prompts[:, t:t + 1],
                                   pos[t])
    tok, out = torch.argmax(logits, -1), []
    for i in range(new):
        out.append(tok)
        logits, _ = tr.decode_step(params, cfg, cache, tok, pos[P + i])
        tok = torch.argmax(logits, -1)
    return torch.cat(out, dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_gpu_serveloop_tokens_equal_eager_across_a_swap(cuda, arch):
    """The captured loop's tokens equal an eager decode loop's before and
    after a ModelBank swap; one capture, ``P + new`` replays a
    ``generate``, and every ``generate`` passes under the sync guard. K8
    runs once per attention layer a step: in the capture's first run and
    in every replay."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ModelBank, ServeLoop
    cfg, params, prompts = _serve_setup(cuda, arch)
    new, max_seq = 8, 16
    n_attn = sum(r for pattern, r in cfg.segments for kind in pattern
                 if kind.startswith("gqa:"))
    want0 = _eager_tokens(cfg, params, prompts, new, max_seq)
    k8 = tda.decode_attention_fwd.launches
    loop = ServeLoop(cfg, params, batch=2, max_seq=max_seq, device=cuda)
    assert (loop.compile_count(), loop.replay_count()) == (1, 0)
    p1 = tr.init_params(1, cfg, torch.float32, device=cuda)
    bank = ModelBank()
    bank.publish(p1, round_i=1)
    replays = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen0, _ = loop.generate(prompts, new)
        replays.append(loop.replay_count())
        assert loop.poll(bank)
        gen1, _ = loop.generate(prompts, new)
        replays.append(loop.replay_count())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tda.decode_attention_fwd.launches - k8 == n_attn * (
        1 + loop.replay_count())
    assert torch.equal(gen0, want0)
    assert torch.equal(gen1, _eager_tokens(cfg, p1, prompts, new, max_seq))
    assert not torch.equal(gen1, gen0)
    P = prompts.shape[1]
    assert replays == [P + new, 2 * (P + new)]
    assert loop.compile_count() == 1


@pytest.mark.gpu
def test_gpu_serveloop_second_capture_raises(cuda):
    """Params on other storage would need a second capture: the call
    raises before capturing, and the loop serves again on its own."""
    from repro_torch.core.graphs import RecaptureError
    from repro_torch.serving import ServeLoop
    from repro_torch.tree import tree_map
    cfg, params, prompts = _serve_setup(cuda, "internlm2-1.8b")
    loop = ServeLoop(cfg, params, batch=2, max_seq=16, device=cuda)
    want, _ = loop.generate(prompts, 4)
    loop.params = tree_map(torch.clone, params)
    with pytest.raises(RecaptureError):
        loop.generate(prompts, 4)
    loop.params = params
    got, _ = loop.generate(prompts, 4)
    assert torch.equal(got, want) and loop.compile_count() == 1


@pytest.mark.gpu
def test_gpu_captured_slstm_matches_plain_loop(cuda):
    """``slstm_scan`` replayed on the card: its hs and final state equal
    ``slstm_cell_ref`` on the same inputs at 1e-5 (the largest difference
    is printed), two layers' params (views of one stacked tensor) share
    one capture and stay unchanged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import xlstm as xl
    cfg = get_smoke_config("xlstm-1.3b")
    g = torch.Generator(device=cuda).manual_seed(0)
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    B, S = 2, 96
    r = torch.randn((2, H, hd, 4 * hd), generator=g, device=cuda) * hd ** -0.5
    b = torch.randn((2, H, 4 * hd), generator=g, device=cuda) * 0.1
    kept = (r.clone(), b.clone())
    xl.release_slstm_graphs()
    worst = 0.0
    for call in range(3):
        layer = call % 2
        wx = torch.randn((B, S, H, 4 * hd), generator=g, device=cuda)
        hs, st = xl.slstm_scan(wx, r[layer], b[layer])
        want_hs, want_st = xl.slstm_cell_ref(
            wx, r[layer], b[layer],
            xl.slstm_state_init(cfg, B, torch.float32, cuda))
        for got, want in [(hs, want_hs)] + [(st[k], want_st[k])
                                            for k in ("h", "c", "n", "m")]:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            worst = max(worst, float((got - want).abs().max()))
    print(f"captured sLSTM vs plain loop: max |diff| {worst:.3e}")
    assert xl.slstm_graph_counts() == {"captures": 1, "replays": 2}
    assert torch.equal(r, kept[0]) and torch.equal(b, kept[1])
    xl.release_slstm_graphs()


@pytest.mark.gpu
def test_gpu_captured_xlstm_training_round_equals_cpu(cuda):
    """Training the xlstm smoke config at S 512 (each recurrence two
    256-step chunks: forward, recomputation and backward inside the
    captured round graph), K = 2, two fused rounds (a capture, a replay),
    every window under the sync guard, against the same rounds on the CPU
    at 1e-4 (logs and params). A prefill through ``impl="kernel"`` before
    and after training replays one ``slstm_scan`` graph: training
    captures none."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import build_data, make_loss_fn
    from repro_torch.models import transformer as tr
    from repro_torch.models import xlstm as xl
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("xlstm-1.3b")
    K, B, S = 2, 2, 512
    data = build_data(cfg, K, B, S, K * B, seed=0)
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    served = tree_map(lambda t: t.to(cuda), params)
    prompt = {"tokens": torch.tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)),
        device=cuda)}
    xl.release_slstm_graphs()
    before = tr.prefill(served, cfg, prompt, impl="kernel")
    assert xl.slstm_graph_counts() == {"captures": 1, "replays": 0}
    runs = {}
    for dev in ("cpu", cuda):
        learner = CoLearner(
            CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=1e-6,
                          epochs_rule="fle", max_rounds=2),
            make_loss_fn(cfg), codec=api.get_codec("exact"),
            round_engine="fused", device=dev)
        runner, guard = learner._runner, []
        captured = runner._round

        def round_graph(*a, _captured=captured, _guard=guard):
            _guard.append(torch.cuda.get_sync_debug_mode())
            return _captured(*a)
        runner._round = round_graph
        runs[str(dev)] = (learner, _rounds(learner, learner.init(params),
                                           data, 2), captured, guard)
    (_, cs, _, _), (_, gs, graph, guard) = runs["cpu"], runs[str(cuda)]
    assert (graph.captures, graph.replays) == (1, 1)
    assert guard == [2, 2]
    for x, y in zip(cs["log"], gs["log"]):
        assert (x.T, x.comm_bytes) == (y.T, y.comm_bytes)
        np.testing.assert_allclose(y.local_losses, x.local_losses,
                                   rtol=1e-4, atol=1e-4)
        if not np.isinf(x.rel_change):
            np.testing.assert_allclose(y.rel_change, x.rel_change,
                                       rtol=1e-4, atol=1e-6)
    assert _param_diff(cs, gs) <= 1e-4
    assert xl.slstm_graph_counts() == {"captures": 1, "replays": 0}
    after = tr.prefill(served, cfg, prompt, impl="kernel")
    assert xl.slstm_graph_counts() == {"captures": 1, "replays": 1}
    torch.testing.assert_close(after, before, rtol=1e-5, atol=1e-5)
    xl.release_slstm_graphs()


# ---------------------------------------------------------------------------
# The rest of the strategy API on the card: the divergence-gated round (the
# epochs, the gate graph, the finalize graph only on a synced round), the
# flat codec's standalone K1 / K2 path (partial participation) and the
# ragged-shard mask, each against the same rounds uncaptured.
# ---------------------------------------------------------------------------
GATE_DELTA = 0.01     # the smoke run's divergences are >= 19% away from it


def _strategy_learner(dev, engine, codec, **kw):
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import make_loss_fn
    cfg, data, params = _fused_setup()
    ccfg = CoLearnConfig(n_participants=3, T0=1, eta0=0.05, epsilon=1e-6,
                         max_rounds=4)
    learner = CoLearner(ccfg, make_loss_fn(cfg),
                        codec=api.get_codec(codec[0], **codec[1]),
                        round_engine=engine, device=dev, **kw)
    return learner, learner.init(params), data


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [("fused", {}), (
    "fused", {"bits": 4, "error_feedback": True})])
def test_gpu_gated_fused_rounds_equal_cpu(cuda, codec):
    """Four gated rounds (quiet, synced, quiet, synced) through the card's
    graphs against the same rounds on the CPU: the same pattern and bills,
    logs at 1e-4 (rel), params within one wire quantum; the gate graph
    captured once and replayed every round, the finalize graph and K3/K4
    only on the synced rounds."""
    import dataclasses
    from repro_torch.core import api
    divs = []

    @dataclasses.dataclass(frozen=True)
    class Recording(api.DivergenceTrigger):
        def should_sync(self, div, round_i, delta=None):
            divs.append(div)
            return super().should_sync(div, round_i, delta)

    learner, state, data = _strategy_learner(
        "cpu", "python", codec, sync_policy=Recording(delta=GATE_DELTA))
    _rounds(learner, state, data, 4)
    assert min(abs(d - GATE_DELTA) for d in divs) > 0.05 * GATE_DELTA, divs
    runs = {}
    for dev in ("cpu", cuda):
        learner, state, data = _strategy_learner(
            dev, "fused", codec,
            sync_policy=api.DivergenceTrigger(delta=GATE_DELTA))
        tops.reset_launch_counts()
        runs[str(dev)] = (learner, _rounds(learner, state, data, 4),
                          tops.launch_counts())
    (_, cs, _), (gl, gs, counts) = runs["cpu"], runs[str(cuda)]
    assert [x.synced for x in gs["log"]] == [False, True, False, True]
    assert [x.comm_bytes for x in gs["log"]] == [x.comm_bytes
                                                 for x in cs["log"]]
    for x, y in zip(cs["log"], gs["log"]):
        np.testing.assert_allclose(y.local_losses, x.local_losses,
                                   rtol=1e-4)
        np.testing.assert_allclose(y.rel_change, x.rel_change, rtol=1e-4)
    bits = codec[1].get("bits", 8)
    assert _param_diff(cs, gs) <= _quantum(cs["params"], bits)
    r = gl._runner
    assert (r._gate.captures, r._gate.replays) == (1, 4)
    assert (r._finalize.captures, r._finalize.replays) == (1, 2)
    assert r._round.captures == 0
    k = ("wire_quant_avg_dequant_ef" if codec[1].get("error_feedback")
         else "wire_quant_avg_dequant")
    assert counts[k] == 2


@pytest.mark.gpu
def test_gpu_quiet_round_leaves_the_residual_untouched(cuda):
    """int4 error feedback: a forced sync (δ = -1) fills the residual, a
    quiet round (δ swapped to 1e9, no rebind, no capture) leaves it, and
    the sync reference, bit for bit, and launches no K4."""
    from repro_torch.core import api
    from repro_torch.tree import leaves
    learner, state, data = _strategy_learner(
        cuda, "fused", ("fused", {"bits": 4, "error_feedback": True}),
        sync_policy=api.DivergenceTrigger(delta=-1.0))
    state = _rounds(learner, state, data, 1)
    runner = learner._runner
    learner.set_sync_policy(api.DivergenceTrigger(delta=1e9))
    assert learner._runner is runner
    res = state["residual"].clone()
    ref = [t.clone() for t in leaves(state["prev_avg"])]
    assert float(res.abs().max()) > 0
    tops.reset_launch_counts()
    state = _rounds(learner, state, data, 1)
    torch.cuda.synchronize()
    assert not state["log"][-1].synced
    assert tops.launch_counts()["wire_quant_avg_dequant_ef"] == 0
    assert torch.equal(state["residual"], res)
    assert all(torch.equal(a, b) for a, b in zip(leaves(state["prev_avg"]),
                                                 ref))
    assert runner._gate.captures == 1 and runner._gate.replays == 2


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4, 1])
def test_gpu_flat_codec_payloads_equal_plain(cuda, bits):
    """The flat codec's standalone encode / decode on the card: one K1
    over the (K, N_pad) buffer, one K2 back; codes and (8/4-bit) scales
    equal the plain version's on the same buffer bit for bit, the decoded
    tree too; the error-feedback roundtrip's new residual as well."""
    from repro_torch.core import api, flatbuf
    from repro_torch.tree import leaves
    rng = np.random.default_rng(bits)
    stacked = {"w": torch.tensor(rng.standard_normal((3, 2, 256)),
                                 dtype=torch.float32, device=cuda),
               "odd": torch.tensor(rng.standard_normal((3, 300)),
                                   dtype=torch.float32, device=cuda)}
    codec = api.FlatFusedIntN(bits=bits, error_feedback=True)
    tops.reset_launch_counts()
    layout, q, s, shp = codec.encode(stacked)
    out = codec.decode((layout, q, s, shp))
    assert tops.launch_counts()["wire_quantize"] == 1
    assert tops.launch_counts()["wire_dequantize"] == 1
    buf = flatbuf.flatten(stacked, layout)
    q_p, s_p, _ = tref.quantize_blockwise_ref(buf, bits=bits)
    nb = q_p.shape[0]
    assert torch.equal(q[:nb], q_p)
    if bits == 1:
        torch.testing.assert_close(s[:nb], s_p, rtol=1e-6, atol=0)
    else:
        assert torch.equal(s[:nb], s_p)
    want = flatbuf.unflatten(tref.dequantize_blockwise_ref(
        q, s, shp, bits=bits), layout)
    assert all(torch.equal(a, b) for a, b in zip(leaves(out), leaves(want)))
    res = torch.tensor(rng.standard_normal((3, layout.n_pad)) * 0.01,
                       dtype=torch.float32, device=cuda)
    rt, new_res = codec.roundtrip_ef(stacked, res.clone())
    y = buf + res
    q_y, s_y, shp_y = tops.quantize_blockwise(y, bits=bits)
    dq = tref.dequantize_blockwise_ref(q_y, s_y, shp_y, bits=bits)
    assert torch.equal(new_res, y - dq)
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(rt), leaves(flatbuf.unflatten(dq, layout))))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["python", "fused"])
def test_gpu_partial_participation_equals_cpu(cuda, engine):
    """Partial participation (m = 2 of 3) over the fused codec's flat
    roundtrip on the card against the CPU: the same draws and bills, logs
    at 1e-4 (rel), params within one wire quantum, K1 and K2 once a
    round."""
    from repro_torch.core import api
    runs = {}
    for dev in ("cpu", cuda):
        learner, state, data = _strategy_learner(
            dev, engine, ("fused", {}),
            aggregator=api.PartialParticipation(m=2),
            shard_sizes=(16, 16, 16))
        tops.reset_launch_counts()
        runs[str(dev)] = (_rounds(learner, state, data, 3),
                          tops.launch_counts())
    (cs, _), (gs, counts) = runs["cpu"], runs[str(cuda)]
    assert [x.comm_bytes for x in gs["log"]] == [x.comm_bytes
                                                 for x in cs["log"]]
    for x, y in zip(cs["log"], gs["log"]):
        np.testing.assert_allclose(y.local_losses, x.local_losses,
                                   rtol=1e-4)
    # one code step of a sampled row moves the mean by its weight, 1/m
    # (``_quantum`` divides the step by K)
    assert _param_diff(cs, gs) <= _quantum(cs["params"], 8) * 3 / 2
    assert counts["wire_quantize"] == counts["wire_dequantize"] == 3


@pytest.mark.gpu
def test_gpu_masked_captured_rounds_equal_uncaptured(cuda):
    """Ragged shards (3, 2 and 1 real batches of 3): the captured rounds
    (the mask read from the learner's one device tensor) equal the same
    rounds run eagerly on the card, and a new mask value in place captures
    nothing new."""
    from repro_torch.launch.train import epoch_batches_fn
    mask = np.array([[True, True, True], [True, True, False],
                     [True, False, False]])
    runs = []
    for captured in (True, False):
        learner, state, data = _strategy_learner(
            cuda, "fused", ("exact", {}), batch_mask=mask)
        learner._runner.graphs.on_cuda = captured
        batches = epoch_batches_fn(data, cuda, 3)
        for _ in range(3):
            state = learner.run_round(state, batches)
        runs.append((learner, state))
    (cl, cs), (ul, us) = runs
    assert cl._fused_round.replays == 2 and ul._fused_round.replays == 0
    _logs_close(us, cs)
    assert _param_diff(us, cs) <= 1e-5
    cl.batch_mask[1, 1] = False
    cl.run_round(cs, batches)
    assert (cl._fused_round.captures, cl._fused_round.replays) == (1, 3)


# --- elastic membership, gossip and round-state checkpoints ------------------
CHURN = (("crash", 1, 1), ("rejoin", 3, 1))
MEMBER_CASES = {
    "churn-full-fused": lambda api, M: {
        "codec": api.get_codec("fused"),
        "churn": M.ScriptedChurn(events=CHURN)},
    "churn-d2-ring-int4-ef": lambda api, M: {
        "codec": api.LeafwiseIntN(bits=4, error_feedback=True),
        "aggregator": api.D2Gossip("ring"),
        "churn": M.ScriptedChurn(events=CHURN)},
    "gossip-exponential": lambda api, M: {
        "codec": api.get_codec("leafwise"),
        "aggregator": api.GraphGossip("exponential")},
}


def _member_learner(dev, engine, case):
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api, membership
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import make_loss_fn
    cfg, data, params = _fused_setup()
    ccfg = CoLearnConfig(n_participants=3, T0=1, eta0=0.05,
                         epochs_rule="fle", max_rounds=4)
    learner = CoLearner(ccfg, make_loss_fn(cfg), round_engine=engine,
                        device=dev, **MEMBER_CASES[case](api, membership))
    return learner, learner.init(params), data


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("case", sorted(MEMBER_CASES))
def test_gpu_churn_gossip_d2_rounds_equal_cpu(cuda, engine, case):
    """Churn (a crash and a rejoin), D² under it, and gossip over the
    time-varying exponential graph: four rounds on the card against the
    same rounds on the CPU, the same live counts and bills, logs at 1e-4,
    params within one wire quantum; on the fused engine no capture after
    round 0, though the live set and the matrix change."""
    runs = {}
    for dev in ("cpu", cuda):
        learner, state, data = _member_learner(dev, engine, case)
        caps = []
        for _ in range(4):
            state = _rounds(learner, state, data, 1)
            if engine == "fused":
                caps.append(learner._runner.graphs.captures)
        runs[str(dev)] = (learner, state, caps)
    (_, cs, _), (gl, gs, caps) = runs["cpu"], runs[str(cuda)]
    assert [(x.live, x.comm_bytes) for x in cs["log"]] == \
        [(x.live, x.comm_bytes) for x in gs["log"]]
    if "churn" in case:
        assert [x.live for x in gs["log"]] == [3, 2, 2, 3]
    for x, y in zip(cs["log"], gs["log"]):
        np.testing.assert_allclose(y.local_losses, x.local_losses, rtol=1e-4)
    bits = 4 if "int4" in case else 8
    assert _param_diff(cs, gs) <= _quantum(cs["params"], bits)
    if engine == "fused":
        assert len(set(caps)) == 1
        assert gl._fused_round.replays == 3


@pytest.mark.gpu
def test_gpu_round_state_restore_keeps_the_graphs(cuda):
    """D² under churn with error feedback, saved after round 2: restored
    into the running fused learner (the storage its graphs read) rounds 3
    and 4 replay without a capture and equal the uninterrupted rounds bit
    for bit."""
    import tempfile
    from repro_torch.checkpoint import io
    from repro_torch.tree import leaves
    case = "churn-d2-ring-int4-ef"
    ref_l, ref, data = _member_learner(cuda, "fused", case)
    ref = _rounds(ref_l, ref, data, 4)
    learner, state, data = _member_learner(cuda, "fused", case)
    state = _rounds(learner, state, data, 2)
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/ck"
        io.save_round_state(path, state)
        state = _rounds(learner, state, data, 2)
        captures = learner._runner.graphs.captures
        state = io.restore_round_state(path, state)
    state = _rounds(learner, state, data, 2)
    assert learner._runner.graphs.captures == captures
    for key in ("params", "residual", "prev_avg"):
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(ref[key]), leaves(state[key])))
    assert state["membership"] == ref["membership"]
    assert [x.local_losses for x in state["log"][-2:]] == \
        [x.local_losses for x in ref["log"][-2:]]


# ---------------------------------------------------------------------------
# Continuous operation (data/stream.py, run_round's on_round_end hook,
# launch/continuous.py): drift and read-only hooks capture nothing, a swap
# is bit-exact, the round window stays sync-free, the card against the CPU.
# ---------------------------------------------------------------------------
def _continuous(dev, drift, engine="fused", sync_policy=None, eps=1e-6):
    """Smoke internlm2, K=3, fused int8, a 48-example token stream (B 4,
    S 16, 2 steps an epoch), ILE with T fixed at 1 unless a policy is
    given; returns (learner, state, stream, cfg)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.data.stream import ShardStream
    from repro_torch.data.synthetic import lm_examples
    from repro_torch.launch.train import make_loss_fn
    from repro_torch.models import transformer as tr
    cfg = get_smoke_config("internlm2-1.8b")
    x, y = lm_examples(0, 48, 16, cfg.vocab_size)
    stream = ShardStream([x, y], 3, 4, 0, drift=drift)
    learner = CoLearner(
        CoLearnConfig(n_participants=3, T0=1, eta0=0.05, epsilon=eps,
                      max_rounds=4),
        make_loss_fn(cfg), codec=api.get_codec("fused"),
        round_engine=engine, sync_policy=sync_policy, device=dev)
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    return learner, learner.init(params), stream, cfg


@pytest.mark.gpu
def test_gpu_drift_and_read_only_hooks_capture_nothing(cuda):
    """Four rounds over a covariate-drifting stream, both banks'
    ``publish_from`` as hooks: the round graph is captured once and
    replayed three times, every window runs under the sync guard, the
    loop captures once, and after every poll its params equal the shared
    model bit for bit while the version it served before stays equal to
    its snapshot."""
    from repro_torch.data.stream import CovariateDrift
    from repro_torch.launch.train import epoch_batches_fn
    from repro_torch.serving import ModelBank, ServeLoop
    from repro_torch.tree import leaves
    learner, state, stream, cfg = _continuous(cuda, CovariateDrift(0.25))
    runner = learner._runner
    graph, guard = runner._round, []

    def recorded(*a):
        guard.append(torch.cuda.get_sync_debug_mode())
        return graph(*a)
    runner._round = recorded
    shared, ens = ModelBank(), ModelBank(mode="ensemble")
    shared.publish(learner.shared_model(state), round_i=0)
    loop = ServeLoop(cfg, learner.shared_model(state), batch=2, max_seq=16,
                     device=cuda)
    assert loop.poll(shared)
    prompts = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)), device=cuda)

    def hook(ln, st):
        shared.publish_from(ln, st)
        ens.publish_from(ln, st)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    batches = epoch_batches_fn(stream, cuda, 2)
    for _ in range(4):
        served = shared.current()
        state = learner.run_round(state, batches, on_round_end=hook)
        assert equal(loop.params, served.params)
        assert loop.poll(shared)
        assert equal(loop.params, learner.shared_model(state))
        assert equal(ens.current().params, state["params"])
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.generate(prompts, 4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert [x.T for x in state["log"]] == [1] * 4
    assert (graph.captures, graph.replays) == (1, 3)
    assert runner.graphs.captures == 1 and loop.compile_count() == 1
    assert guard == [2] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["python", "fused"])
def test_gpu_continuous_rounds_equal_cpu(cuda, engine):
    """An abrupt drift at round 2 under the divergence trigger (δ 0.0088:
    the divergences run 0.0070-0.0106, >= 17% away) with ``publish_from``
    as the hook: the card's sync pattern, bills, versions and staleness
    equal the CPU's, its losses within 1e-4."""
    from repro_torch.core import api
    from repro_torch.data.stream import AbruptDrift
    from repro_torch.launch.train import epoch_batches_fn
    from repro_torch.serving import ModelBank
    runs = {}
    for dev in ("cpu", cuda):
        learner, state, stream, _ = _continuous(
            dev, AbruptDrift(at_round=2), engine,
            api.DivergenceTrigger(delta=0.0088))
        bank = ModelBank()
        vers = []
        for _ in range(4):
            state = learner.run_round(state, epoch_batches_fn(stream, dev, 2),
                                      on_round_end=bank.publish_from)
            vers.append((bank.version, bank.staleness(state["round"])))
        runs[str(dev)] = (state, vers)
    (cs, cv), (gs, gv) = runs["cpu"], runs[str(cuda)]
    assert [x.synced for x in gs["log"]] == [x.synced for x in cs["log"]] \
        == [False, True, False, True]
    assert gv == cv == [(0, 1_000_000_000), (1, 0), (1, 1), (2, 0)]
    assert [x.comm_bytes for x in gs["log"]] == \
        [x.comm_bytes for x in cs["log"]]
    for x, y in zip(cs["log"], gs["log"]):
        np.testing.assert_allclose(y.local_losses, x.local_losses, rtol=1e-4)
        np.testing.assert_allclose(y.rel_change, x.rel_change, rtol=1e-4)


@pytest.mark.gpu
def test_gpu_continuous_cli_runs(cuda, tmp_path, capsys):
    """The continuous CLI on the card (divergence trigger, abrupt drift):
    exit 0, one decode capture, every published version persisted."""
    from repro_torch.launch import continuous
    assert continuous.main(["--device", "cuda", "--sync-policy",
                            "divtrigger", "--trigger-delta", "0.002",
                            "--drift", "abrupt", "--drift-round", "2",
                            "--rounds", "4", "--bank-dir",
                            str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    rounds = [x for x in out if x.startswith("round ")]
    assert len(rounds) == 4 and all("compiles=1" in x for x in rounds)
    version = int(out[-1].rsplit("v", 1)[1])
    assert sorted(p.name for p in tmp_path.glob("v*.npz")) == sorted(
        f"v{v}.npz" for v in range(1, version + 1))


# ---------------------------------------------------------------------------
# The paper's tasks (``models/convnets.py``, ``paper_tasks/harness.py``)
def _convnet_cases():
    from repro_torch.models import convnets as cn
    return [(name, fns) for models in (cn.IMAGE_MODELS, cn.TEXT_MODELS,
                                       cn.AUDIO_MODELS)
            for name, fns in models.items()]


def _convnet_batch(name, n=32):
    from repro_torch.data.synthetic import audio_like, image_like, text_like
    data = (image_like if name.endswith("_tiny") else text_like
            if name.endswith("_text") else audio_like)
    x, y = data(seed=0, n=n)
    return torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64)


def _convnet_outputs(apply_fn, params, x, y):
    from repro_torch.paper_tasks.harness import cls_loss
    from repro_torch.tree import leaves
    ps = leaves(params)
    for t in ps:
        t.requires_grad_(True)
    logits = apply_fn(params, x)
    g_sum = torch.autograd.grad(logits.sum(), ps)
    loss, _ = cls_loss(apply_fn)(params, (x, y))
    g_loss = torch.autograd.grad(loss, ps)
    return [t.detach().cpu() for t in (logits, loss, *g_sum, *g_loss)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _ in _convnet_cases()])
def test_gpu_convnets_match_cpu(cuda, name):
    """Logits and every gradient, card against CPU from the same params,
    at 1e-5, with cuDNN's TF32 at PyTorch's default (on)."""
    from repro_torch.tree import tree_map
    init_fn, apply_fn = dict(_convnet_cases())[name]
    params = init_fn(torch.Generator().manual_seed(0))
    x, y = _convnet_batch(name)
    want = _convnet_outputs(apply_fn, params, x, y)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = _convnet_outputs(apply_fn, tree_map(
            lambda t: t.detach().to(cuda), params), x.to(cuda), y.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.backends.cudnn.allow_tf32 == prev
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _scaled_err(got, want):
    """Worst |got - want| over max |want|, per tensor: the f32 summation
    order alone moves a 2,048-term weight-gradient sum by ~1e-6 of its
    scale, TF32 rounding by ~1e-4 to 1e-3."""
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


@pytest.mark.gpu
def test_gpu_convnet_conv_stays_f32_under_tf32(cuda):
    """A 3x3 conv of fan-in 3·3·48: cuDNN under TF32 is ~1e-3 off the CPU,
    the port's ``_conv`` (forward and both gradients) within 1e-5 of each
    tensor's scale with the global TF32 flag left on, and the flag is on
    again after the call."""
    import torch.nn.functional as F
    from repro_torch.models.convnets import _conv
    g = torch.Generator().manual_seed(3)
    x = torch.randn(32, 8, 8, 48, generator=g)
    w = torch.randn(3, 3, 48, 48, generator=g) * (3 * 3 * 48) ** -0.5

    def run(dev, fn):
        xd = x.to(dev).requires_grad_(True)
        wd = w.to(dev).requires_grad_(True)
        y = fn(xd, wd)
        gx, gw = torch.autograd.grad((y * y).sum(), (xd, wd))
        return [t.detach().cpu() for t in (y, gx, gw)]

    def raw(xd, wd):
        y = F.conv2d(F.pad(xd.permute(0, 3, 1, 2), (1, 1, 1, 1)),
                     wd.permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1)

    want = run("cpu", _conv)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = run(cuda, raw)
        got = run(cuda, _conv)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    # the test can fail: TF32 convolutions are well outside the tolerance
    raw_err, port_err = _scaled_err(tf32, want), _scaled_err(got, want)
    assert max(raw_err) > 1e-4, raw_err
    assert max(port_err) <= 1e-5, (port_err, raw_err)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_gpu_captured_resnet_round_equals_python(cuda):
    """resnet_tiny through the harness, K = 5, 3 rounds: the fused engine's
    captured rounds equal the python engine's on the card (logs at 1e-5,
    accuracies within one test example, the same shared model at 1e-5)."""
    from repro_torch.data.synthetic import image_like
    from repro_torch.models.convnets import IMAGE_MODELS
    from repro_torch.paper_tasks.harness import run_colearn
    from repro_torch.tree import leaves
    init_fn, apply_fn = IMAGE_MODELS["resnet_tiny"]
    params = init_fn(torch.Generator().manual_seed(0))
    train, test = image_like(0, n=640), image_like(1000, n=200)
    runs = {eng: run_colearn(lambda gen: params, apply_fn, train, test,
                             K=5, rounds=3, T0=1, epsilon=0.03,
                             steps_cap=2, engine=eng, device=cuda)
            for eng in ("python", "fused")}
    py, fu = runs["python"], runs["fused"]
    rnd = fu["learner"]._fused_round
    assert rnd.captures == len(set(fu["T"])) and rnd.replays >= 1
    assert py["T"] == fu["T"] and py["comm_bytes"] == fu["comm_bytes"]
    for a, b in zip(py["state"]["log"], fu["state"]["log"]):
        np.testing.assert_allclose(b.local_losses, a.local_losses,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose([b.lr_first, b.lr_last, b.rel_change],
                                   [a.lr_first, a.lr_last, a.rel_change],
                                   rtol=1e-5, atol=1e-5)
    assert all(abs(a - b) <= 1 / 200 + 1e-9
               for a, b in zip(py["acc"], fu["acc"]))
    for a, b in zip(leaves(py["final_params"]), leaves(fu["final_params"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


POD_WORKER = r"""
import sys
import torch
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves_with_path, tree_map

dev = M.init_process_mesh(rank, world, f"file://{d}/rdv", "gloo", "cuda")
pmesh = M.make_sim_mesh((world,), ("pod",), "cuda")
cfg = get_smoke_config("internlm2-1.8b")
g = torch.Generator(device=dev).manual_seed(7)
start = tree_map(lambda t: t[None] + 0.02 * torch.randn(
    (world, *t.shape), generator=g, device=dev),
    tr.init_params(0, cfg, torch.float32, device=dev))
local = tree_map(lambda t: t[rank:rank + 1].clone(), start)
gb = torch.Generator(device=dev).manual_seed(8)
batch = {k: torch.randint(0, cfg.vocab_size, (1, world, 2, 2, 16),
                          generator=gb, device=dev)
         for k in ("tokens", "labels")}
rf = steps.make_fused_round_step(
    cfg, CoLearnConfig(n_participants=world, T0=1, max_rounds=1),
    mesh=pmesh, codec="fused")
from repro_torch.core import flatbuf
codes, scales, _ = ops.quantize_blockwise(
    flatbuf.flatten(local, flatbuf.make_layout(local)))
ops.reset_launch_counts()
local, _, aux = rf(local, (), {k: v[:, rank:rank + 1]
                               for k, v in batch.items()}, 0)
torch.cuda.synchronize()
torch.save({"params": {p: t[0].cpu() for p, t in leaves_with_path(local)},
            "losses": aux["losses"].cpu(), "rel": aux["rel"].cpu(),
            "codes": codes.cpu(), "scales": scales.cpu(),
            "launches": ops.launch_counts()}, f"{d}/rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


@pytest.mark.gpu
def test_gpu_pod_round_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card),
    one ``make_fused_round_step(mesh=)`` round of fused int8: K1 and K2
    once per rank, each rank's K1 codes and scales equal to its row of K1
    over the stacked (2, N_pad) buffer, the ranks' averages equal bit for
    bit, and both within 1e-5 of the simulation-path step on the card
    from the same rows."""
    import os
    import subprocess
    import sys
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves_with_path, tree_map
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", POD_WORKER, str(k),
                               "2", str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for k in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    ranks = [torch.load(tmp_path / f"rank{k}.pt") for k in range(2)]
    for r in ranks:
        assert r["launches"]["wire_quantize"] == 1
        assert r["launches"]["wire_dequantize"] == 1
        assert r["launches"]["wire_quant_avg_dequant"] == 0
    assert all(torch.equal(ranks[0]["params"][p], ranks[1]["params"][p])
               for p in ranks[0]["params"])
    cfg = get_smoke_config("internlm2-1.8b")
    g = torch.Generator(device=cuda).manual_seed(7)
    start = tree_map(lambda t: t[None] + 0.02 * torch.randn(
        (2, *t.shape), generator=g, device=cuda),
        tr.init_params(0, cfg, torch.float32, device=cuda))
    gb = torch.Generator(device=cuda).manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 2, 2, 2, 16),
                              generator=gb, device=cuda)
             for k in ("tokens", "labels")}
    from repro_torch.core import flatbuf
    codes, scales, _ = tops.quantize_blockwise(
        flatbuf.flatten(start, flatbuf.make_layout(start)))
    rows = codes.shape[0] // 2
    for k, r in enumerate(ranks):
        assert torch.equal(r["codes"], codes[k * rows:(k + 1) * rows].cpu())
        assert torch.equal(r["scales"], scales[k * rows:(k + 1) * rows].cpu())
    rf = steps.make_fused_round_step(
        cfg, CoLearnConfig(n_participants=2, T0=1, max_rounds=1),
        codec="fused", device=cuda)
    start, _, aux = rf(start, (), batch, 0)
    for p, t in leaves_with_path(start):
        torch.testing.assert_close(ranks[0]["params"][p], t[0].cpu(),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(ranks[0]["losses"], aux["losses"].cpu(),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ranks[0]["rel"], aux["rel"].cpu(),
                               rtol=1e-5, atol=1e-6)


RECAPTURE = r"""
import torch
from repro_torch.core.graphs import GraphSet
dev = torch.device("cuda")
gs = GraphSet(dev)
w = torch.randn(4096, 4096, device=dev)
step = gs.capture(lambda x: torch.tanh(x @ w) @ w, "step")
for _ in range(3):
    x = torch.randn(4096, 4096, device=dev)  # new storage: a new graph
    torch.testing.assert_close(step(x), torch.tanh(x @ w) @ w)
print(step.captures, step.replays)
"""


@pytest.mark.gpu
def test_gpu_graph_set_recaptures_when_its_only_graph_is_dropped(cuda):
    """A ``GraphSet`` whose one graph is replaced (its argument moved to
    other storage) captures the new one into a fresh pool: the caching
    allocator asserts on a capture into a pool that no graph uses any
    more but that still holds cached blocks (``make_fused_round_step``'s
    epochs are the only graph of their set, and a caller may pass new
    params each round). Run in its own process under the allocator
    setting ``chip_smoke.py`` uses."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    r = subprocess.run([sys.executable, "-c", RECAPTURE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["3", "2"]


NCCL_SHARED = r"""
import sys
from repro_torch.launch import mesh as M
rank, d = int(sys.argv[1]), sys.argv[2]
try:
    M.init_process_mesh(rank, 2, f"file://{d}/rdv", "nccl", "cuda:0")
except ValueError as e:
    print("REFUSED" if "gloo" in str(e) else "OTHER", flush=True)
"""


@pytest.mark.gpu
def test_gpu_nccl_ranks_sharing_a_card_are_refused(cuda, tmp_path):
    """Two NCCL ranks on one card (NCCL's "Duplicate GPU detected") are
    refused when they join, with the fix named; nothing switches the
    backend."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_SHARED, str(k),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for k in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [o.strip() for o, _ in outs] == ["REFUSED", "REFUSED"], outs


# ---------------------------------------------------------------------------
# Per-layer recomputation and the guards on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_no_transfer_raises_on_a_sync_and_restores_the_mode(cuda):
    """``guards.no_transfer`` on the card: a ``.item()`` (a host sync)
    raises inside it, the previous sync debug mode comes back after it,
    and a pinned non-blocking staging copy does not raise."""
    from repro_torch.analysis import guards
    from repro_torch.core import engine
    x = torch.ones(4, device=cuda)
    torch.cuda.set_sync_debug_mode(0)
    with guards.no_transfer(cuda):
        assert torch.cuda.get_sync_debug_mode() == 2
        staged = engine.stage(np.arange(3), np.int32, cuda)
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert staged.device.type == "cuda"


@pytest.mark.gpu
def test_gpu_no_retrace_raises_before_a_second_capture(cuda):
    """``guards.no_retrace(limit=1)`` over a captured function on the
    card: replays of one layout pass, a second layout raises before it is
    captured, and the graph held still replays."""
    from repro_torch.analysis import guards
    from repro_torch.core.graphs import GraphSet
    fn = GraphSet(cuda).capture(lambda x: x * 2, "doubler", inputs=(0,))
    step = guards.no_retrace(fn, limit=1, what="doubler")
    for v in (1.0, 3.0):
        out = step(torch.full((8,), v, device=cuda))
        assert torch.equal(out, torch.full((8,), 2 * v, device=cuda))
    assert (fn.captures, fn.replays) == (1, 1)
    with pytest.raises(guards.RetraceError, match="limit of 1"):
        step(torch.ones(9, device=cuda))
    assert fn.captures == 1
    assert torch.equal(step(torch.ones(8, device=cuda)),
                       torch.full((8,), 2.0, device=cuda))


def _remat_round(cuda, remat):
    """Two captured rounds of ``make_fused_round_step`` (fused int8, K 2)
    on the internlm2 smoke config, from fixed params and batches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import averaging
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = get_smoke_config("internlm2-1.8b")
    params = averaging.stack_participants(
        tr.init_params(0, cfg, torch.float32, device=cuda), 2)
    g = torch.Generator(device=cuda).manual_seed(3)
    batches = {k: torch.randint(0, cfg.vocab_size, (1, 2, 2, 2, 16),
                                generator=g, device=cuda)
               for k in ("tokens", "labels")}
    rf = steps.make_fused_round_step(
        cfg, CoLearnConfig(n_participants=2, T0=1, max_rounds=2),
        codec="fused", remat=remat, device=cuda)
    out = []
    for i in range(2):
        params, _, aux = rf(params, (), batches, i)
        out.append(([t.clone() for t in leaves(params)],
                    aux["losses"].clone()))
    return out, rf.graphs.captures


@pytest.mark.gpu
def test_gpu_remat_round_is_captured_and_equals_no_remat(cuda):
    """The fused round step with per-layer recomputation (the default)
    captures its epochs once and equals ``remat=False`` after each round
    at 1e-5 (the embedding's backward adds with atomics)."""
    on, cap_on = _remat_round(cuda, True)
    off, cap_off = _remat_round(cuda, False)
    assert cap_on == cap_off == 1
    for (pa, la), (pb, lb) in zip(on, off):
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)
        for a, b in zip(pa, pb):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_gpu_remat_nests_with_chunked_scan(cuda):
    """xlstm's smoke config at S 512 (two 256-step chunks a recurrence,
    each checkpointed inside the layer's checkpoint): the loss and every
    gradient with and without per-layer recomputation at 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = get_smoke_config("xlstm-1.3b")
    params = tr.init_params(0, cfg, torch.float32, device=cuda)
    ps = leaves(params)
    for t in ps:
        t.requires_grad_()
    g = torch.Generator(device=cuda).manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 512), generator=g,
                              device=cuda) for k in ("tokens", "labels")}
    res = {}
    for remat in (True, False):
        loss, _ = tr.loss_fn(params, cfg, batch, remat=remat)
        res[remat] = (loss.detach(), torch.autograd.grad(loss, ps))
    torch.testing.assert_close(res[True][0], res[False][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(res[True][1], res[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Program spans on the card (repro_torch.spans): the device clocks.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_round_marks_split_the_replay(cuda):
    """A replayed round's ``epochs_ms + finalize_ms`` (the marks captured
    inside its graph) lies within 2% of CUDA events around the whole
    replay; with tracing off the log carries None, and a round captured
    with tracing on reads its split too. A spin kernel runs before the
    first outer event, so the host has launched the graph by the time the
    device reaches it: the outer events then hold the replay's device
    time, not the launch's host latency."""
    from repro_torch import spans
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import (build_data, epoch_batches_fn,
                                          make_loss_fn)
    cfg, _, params = _fused_setup()
    data = build_data(cfg, 3, 8, 128, 3 * 8 * 4, seed=0)
    learner = CoLearner(
        CoLearnConfig(n_participants=3, T0=1, eta0=0.05, epochs_rule="fle",
                      max_rounds=4),
        make_loss_fn(cfg), codec=api.get_codec("fused"),
        round_engine="fused", device=cuda)
    state = learner.init(params)
    batches = epoch_batches_fn(data, cuda, 4)
    spans.enable()
    try:
        state = learner.run_round(state, batches)       # the capture
    finally:
        spans.disable()
    log = state["log"][-1]
    assert log.epochs_ms > 0 and log.finalize_ms > 0
    state = learner.run_round(state, batches)
    assert state["log"][-1].epochs_ms is None
    runner = learner._runner
    graph = runner._round
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(*a):
        torch.cuda._sleep(10_000_000)
        outer[0].record()
        out = graph(*a)
        outer[1].record()
        return out
    runner._round = timed
    spans.enable()
    try:
        for _ in range(2):
            state = learner.run_round(state, batches)
    finally:
        spans.disable()
        runner._round = graph
    log = state["log"][-1]
    whole = outer[0].elapsed_time(outer[1])
    assert log.epochs_ms > 0 and log.finalize_ms > 0
    assert abs(log.epochs_ms + log.finalize_ms - whole) <= 0.02 * whole, (
        log.epochs_ms, log.finalize_ms, whole)
    assert graph.replays == 3


@pytest.mark.gpu
def test_gpu_generate_step_ms_and_timed_prefill_spans(cuda):
    """While tracing, ``generate``'s stats carry ``new - 1`` positive
    token gaps, and under a profiler kineto mirrors a prefill's spans on
    the device's timeline, which times them: one ``rt.prefill`` mirror,
    a positive ``rt.mixer.*`` and ``rt.ffn.*`` mirror per layer, each
    inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import spans
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.serving import ServeLoop
    cfg, params, prompts = _serve_setup(cuda, "jamba-v0.1-52b")
    loop = ServeLoop(cfg, params, batch=2, max_seq=16, device=cuda)
    new = 5
    _, off = loop.generate(prompts, new)
    assert "step_ms" not in off
    step = make_prefill_step(cfg, impl="kernel")
    step(params, {"tokens": prompts})                   # warm-up
    torch.cuda.synchronize()
    spans.enable()
    try:
        _, on = loop.generate(prompts, new)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, {"tokens": prompts})
            torch.cuda.synchronize()
    finally:
        spans.disable()
    assert len(on["step_ms"]) == new - 1 and min(on["step_ms"]) > 0
    def ns(e):
        if hasattr(e, "start_ns"):
            return e.start_ns(), e.start_ns() + e.duration_ns()
        return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())
    mirrors = [(e.name(), *ns(e))
               for e in prof.profiler.kineto_results.events()
               if e.device_type() != DeviceType.CPU
               and e.name().startswith("rt.")]
    (lo, hi), = [(a, b) for n, a, b in mirrors if n == "rt.prefill"]
    n_layers = sum(len(p) * n for p, n in cfg.segments)
    for part in ("rt.mixer.", "rt.ffn."):
        mine = [(a, b) for n, a, b in mirrors if n.startswith(part)]
        assert len(mine) == n_layers, (part, mirrors)
        assert all(lo <= a < b <= hi for a, b in mine)
