"""Dispatch for the wire kernels K1-K4, flash attention K5, the selective
scan K6, mLSTM K7 and decode attention K8.

There is no ``impl`` knob: a tensor on the CPU goes to the plain version
(``ref.py``), as does one on ``meta`` (the dry run's shapes), a CUDA
tensor to the hand-written kernel's wrapper (``quantize.py`` /
``comm.py`` / ``flash_attention.py`` / ``selective_scan.py`` /
``mlstm.py`` / ``decode_attention.py``), which launches it or raises.
Nothing falls back from the kernel to the plain version. A DTensor
raises ``TypeError``: a kernel never runs on a local shard as if it were
the whole tensor.

``KERNELS`` names each kernel's wrapper; ``launch_counts`` /
``reset_launch_counts`` read and zero the per-wrapper launch counters.
"""
from __future__ import annotations

from repro_torch.kernels import comm as _comm
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _ml
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import selective_scan as _ss

KERNELS = {
    "wire_quantize": _qz.quantize_blockwise_fwd,                 # K1
    "wire_dequantize": _qz.dequantize_blockwise_fwd,             # K2
    "wire_quant_avg_dequant": _comm.quant_avg_dequant_fwd,       # K3
    "wire_quant_avg_dequant_ef": _comm.quant_avg_dequant_ef_fwd,  # K4
    "flash_attention": _fa.flash_attention_fwd,                  # K5
    "selective_scan": _ss.selective_scan_fwd,                    # K6
    "mlstm": _ml.mlstm_fwd,                                      # K7
    "decode_attention": _da.decode_attention_fwd,                # K8
}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def _on_cuda(*tensors):
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "a DTensor reached a kernel wrapper: a kernel would run on one "
            "rank's local shard as if it were the whole tensor; a mesh step "
            "takes impl='ref', and the codecs gather a pod's row first")
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds in ({"cpu"}, {"meta"}):
        return False
    raise ValueError(f"the kernels take tensors on one device, cuda, cpu "
                     f"or meta; got {sorted(kinds)}")


def quantize_blockwise(x, *, block=256, bits=8):
    if _on_cuda(x):
        return _qz.quantize_blockwise_fwd(x, block=block, bits=bits)
    return _ref.quantize_blockwise_ref(x, block=block, bits=bits)


def dequantize_blockwise(q, scale, shape, *, bits=8):
    if _on_cuda(q, scale):
        return _qz.dequantize_blockwise_fwd(q, scale, shape, bits=bits)
    return _ref.dequantize_blockwise_ref(q, scale, shape, bits=bits)


def quant_avg_dequant(buf, *, block=256, bits=8):
    """Fused Eq. 2 wire pass over a (K, n) flat buffer: quantize every
    participant row blockwise at ``bits``, dequantize, mean -> (n,) f32."""
    if _on_cuda(buf):
        return _comm.quant_avg_dequant_fwd(buf, block=block, bits=bits)
    return _ref.quant_avg_dequant_ref(buf, block=block, bits=bits)


def quant_avg_dequant_ef(buf, residual, *, block=256, bits=8):
    """Error-feedback fused Eq. 2 wire pass: quantize ``buf + residual``
    per participant row; return ((n,) mean, new residual). The new residual
    is written into ``residual`` in place and returned."""
    if _on_cuda(buf, residual):
        return _comm.quant_avg_dequant_ef_fwd(buf, residual, block=block,
                                              bits=bits)
    return _ref.quant_avg_dequant_ef_ref(buf, residual, block=block,
                                         bits=bits)


def flash_attention(q, k, v, *, n_kv_heads, window=0, softmax_scale=None):
    """Causal attention (optional sliding window, GQA), forward only.
    q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd|hd_v) -> (B,Sq,H,hd_v) in q's dtype."""
    if _on_cuda(q, k, v):
        return _fa.flash_attention_fwd(q, k, v, n_kv_heads=n_kv_heads,
                                       window=window,
                                       softmax_scale=softmax_scale)
    return _ref.flash_attention_ref(q, k, v, n_kv_heads=n_kv_heads,
                                    window=window,
                                    softmax_scale=softmax_scale)


def selective_scan(xc, dt, Bm, Cm, A, D):
    """Mamba selective scan from a zero state, forward only. xc, dt:
    (B,S,di), Bm, Cm: (B,S,st), A: (di,st), D: (di,) -> (y (B,S,di) f32,
    h_final (B,di,st) f32)."""
    if _on_cuda(xc, dt, Bm, Cm, A, D):
        return _ss.selective_scan_fwd(xc, dt, Bm, Cm, A, D)
    return _ref.selective_scan_ref(xc, dt, Bm, Cm, A, D)


def mlstm(q, k, v, ig, fg):
    """Stabilized mLSTM recurrence from a zero state, forward only.
    q,k,v: (B,S,H,hd), ig,fg: (B,S,H) raw gates -> (h (B,S,H,hd) f32,
    None), as the JAX kernel path returns no final state."""
    if _on_cuda(q, k, v, ig, fg):
        return _ml.mlstm_fwd(q, k, v, ig, fg), None
    h, _ = _ref.mlstm_ref(q, k, v, ig, fg)
    return h, None


def decode_attention(q, ck, cv, pos, *, window, softmax_scale):
    """Single-token attention against a KV cache, forward only. q:
    (B,1,H,hd), ck/cv: (B,S,KV,hd), pos: 0-d int tensor, the position of
    the token (the slots after it are not read; with ``window`` the cache
    is a ring of S slots) -> (B,1,H,hd)."""
    if _on_cuda(q, ck, cv, pos):
        return _da.decode_attention_fwd(q, ck, cv, pos, window=window,
                                        softmax_scale=softmax_scale)
    return _ref.decode_attention_ref(q, ck, cv, pos, window=window,
                                     softmax_scale=softmax_scale)
