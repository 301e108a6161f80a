"""Compact conv/recurrent classifiers for the paper-claims experiments,
ported from ``repro/models/convnets.py``.

The paper's testbeds (VGG/ResNet/DenseNet/Inception on CIFAR, LSTM/Capsule
on text, CRNN on audio) as the same reduced models:
  * vgg_tiny / resnet_tiny / densenet_tiny — image task (Table 2 analog)
  * gru_text / transformer_text           — text task  (Table 4 analog)
  * crnn_{ap,mp,sa,ma}                    — audio task (Table 6 analog:
                                            avg/max pooling, single/multi attention)
All are ``init(gen, ...) -> params`` / ``apply(params, x) -> logits`` over
plain tensor dicts, random numbers from an explicit ``torch.Generator``.

The parameter layout is the reference's: conv weights HWIO ``(k, k, cin,
cout)``, activations NHWC. The flat wire, the leaf-wise int8 blocks and the
path-keyed npz all follow leaf and element order, so the same layout keeps
a compressed round bit-comparable with the JAX package and carries JAX
params across unchanged. ``_conv`` permutes to NCHW/OIHW for the one call
and back, pads as JAX's ``"SAME"`` does (low ``total // 2``, high the rest:
(0, 1) at stride 2 on an even size), and computes in f32 on the card
forward and backward (``_ConvF32``): cuDNN's default TF32 would be about
1e-3 off at fan-in 3·3·48.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal


@contextlib.contextmanager
def _ieee_convs(on_cuda):
    """cuDNN convolutions in full f32 (TF32 off) for the block, the
    caller's setting restored after it."""
    if not on_cuda:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _ConvF32(torch.autograd.Function):
    """``F.conv2d`` (NCHW, OIHW, no padding) whose forward AND backward run
    with TF32 off: the backward convolutions read the global flag when
    autograd runs them, after a forward-only context has ended."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _ieee_convs(x.is_cuda):
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        with _ieee_convs(g.is_cuda):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [s, s], [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def _same_pads(n, k, stride):
    """JAX's ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NHWC ``x`` with an HWIO ``w`` -> NHWC, ``"SAME"`` padding."""
    k = w.shape[0]
    ph, pw = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k,
                                                           stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    y = _ConvF32.apply(xn, w.permute(3, 2, 0, 1), stride)
    return y.permute(0, 2, 3, 1)


def _conv_init(gen, k, cin, cout):
    return trunc_normal(gen, (k, k, cin, cout), (k * k * cin) ** -0.5,
                        torch.float32)


def _dense_init(gen, din, dout):
    return {"w": trunc_normal(gen, (din, dout), din ** -0.5, torch.float32),
            "b": torch.zeros(dout, device=gen.device)}


def _dense(p, x):
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# Image models
# ---------------------------------------------------------------------------
def vgg_tiny_init(gen, n_classes=10, c=24, cin=3):
    return {"c1": _conv_init(gen, 3, cin, c),
            "c2": _conv_init(gen, 3, c, 2 * c),
            "c3": _conv_init(gen, 3, 2 * c, 2 * c),
            "head": _dense_init(gen, 2 * c, n_classes)}


def vgg_tiny_apply(p, x):
    x = F.relu(_conv(x, p["c1"], 2))
    x = F.relu(_conv(x, p["c2"], 2))
    x = F.relu(_conv(x, p["c3"], 1))
    return _dense(p["head"], x.mean((1, 2)))


def resnet_tiny_init(gen, n_classes=10, c=24, cin=3):
    return {"c1": _conv_init(gen, 3, cin, c),
            "r1": _conv_init(gen, 3, c, c), "r2": _conv_init(gen, 3, c, c),
            "c2": _conv_init(gen, 3, c, 2 * c),
            "head": _dense_init(gen, 2 * c, n_classes)}


def resnet_tiny_apply(p, x):
    x = F.relu(_conv(x, p["c1"], 2))
    h = F.relu(_conv(x, p["r1"]))
    x = F.relu(x + _conv(h, p["r2"]))               # residual block
    x = F.relu(_conv(x, p["c2"], 2))
    return _dense(p["head"], x.mean((1, 2)))


def densenet_tiny_init(gen, n_classes=10, c=16, cin=3):
    return {"c1": _conv_init(gen, 3, cin, c),
            "d1": _conv_init(gen, 3, c, c),
            "d2": _conv_init(gen, 3, 2 * c, c),
            "head": _dense_init(gen, 3 * c, n_classes)}


def densenet_tiny_apply(p, x):
    x = F.relu(_conv(x, p["c1"], 2))
    h1 = F.relu(_conv(x, p["d1"]))
    x = torch.cat([x, h1], -1)                      # dense connectivity
    h2 = F.relu(_conv(x, p["d2"]))
    x = torch.cat([x, h2], -1)
    return _dense(p["head"], x.mean((1, 2)))


# ---------------------------------------------------------------------------
# GRU cell (text + audio recurrent backbones)
# ---------------------------------------------------------------------------
def gru_init(gen, din, dh):
    return {"wx": trunc_normal(gen, (din, 3 * dh), din ** -0.5,
                               torch.float32),
            "wh": trunc_normal(gen, (dh, 3 * dh), dh ** -0.5, torch.float32),
            "b": torch.zeros(3 * dh, device=gen.device)}


def gru_apply(p, x):
    """x: (B,S,din) -> (B,S,dh). The reference's cell: the bias on the
    input projection only, the reset gate on the candidate's recurrent
    term ``(h @ wh)_n``; ``lax.scan`` becomes a loop over S."""
    dh = p["wh"].shape[0]
    wx = x @ p["wx"] + p["b"]
    h = torch.zeros((x.shape[0], dh), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        wx_t = wx[:, t]
        hw = h @ p["wh"]
        r, z, _ = torch.split(wx_t + hw, dh, -1)
        n = torch.tanh(wx_t[:, 2 * dh:] + torch.sigmoid(r) * hw[:, 2 * dh:])
        z = torch.sigmoid(z)
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, 1)


def gru_text_init(gen, vocab=128, d=48, n_classes=6):
    return {"emb": trunc_normal(gen, (vocab, d), d ** -0.5, torch.float32),
            "fwd": gru_init(gen, d, d), "bwd": gru_init(gen, d, d),
            "head": _dense_init(gen, 2 * d, n_classes)}


def gru_text_apply(p, x):
    e = p["emb"][x]                                  # (B,S,d)
    hf = gru_apply(p["fwd"], e)
    hb = torch.flip(gru_apply(p["bwd"], torch.flip(e, [1])), [1])
    h = torch.cat([hf, hb], -1).amax(1)              # bi-GRU + max pool
    return _dense(p["head"], h)


def transformer_text_init(gen, vocab=128, d=48, n_classes=6):
    """Stands in for the paper's Capsule text model (see DESIGN.md)."""
    return {"emb": trunc_normal(gen, (vocab, d), d ** -0.5, torch.float32),
            "wq": _dense_init(gen, d, d), "wk": _dense_init(gen, d, d),
            "wv": _dense_init(gen, d, d), "ff": _dense_init(gen, d, d),
            "head": _dense_init(gen, d, n_classes)}


def transformer_text_apply(p, x):
    """Unmasked softmax attention in plain matmuls (not a kernel path)."""
    e = p["emb"][x]
    q, k, v = _dense(p["wq"], e), _dense(p["wk"], e), _dense(p["wv"], e)
    a = torch.softmax(q @ k.transpose(1, 2) / q.shape[-1] ** 0.5, -1)
    h = e + a @ v
    h = h + F.relu(_dense(p["ff"], h))
    return _dense(p["head"], h.mean(1))


# ---------------------------------------------------------------------------
# CRNN audio models (paper Table 6: AP / MP / SA / MA pooling variants)
# ---------------------------------------------------------------------------
def crnn_init(gen, mels=32, d=48, n_classes=10, variant="ap"):
    p = {"conv": _conv_init(gen, 3, 1, 8),
         "gru": gru_init(gen, 8 * (mels // 2), d),
         "head": _dense_init(gen, d, n_classes)}
    if variant in ("sa", "ma"):
        p["att1"] = _dense_init(gen, d, 1)
    if variant == "ma":
        p["att2"] = _dense_init(gen, d, 1)
    return p


def crnn_apply(p, x, variant="ap"):
    """x: (B,frames,mels). The folds below reshape the NHWC conv output
    (B, T, M, 8) literally, as the reference does."""
    B, T, M = x.shape
    h = F.relu(_conv(x[..., None], p["conv"], 1))            # (B,T,M,8)
    h = h.reshape(B, T // 2, 2, M, 8).mean(2)                # pool time
    h = h.reshape(B, T // 2, 2, (M // 2) * 8 * 2 // 2)       # fold mels
    h = h.mean(2)
    h = gru_apply(p["gru"], h)                               # (B,T',d)
    v = variant
    if v == "ap":
        g = h.mean(1)
    elif v == "mp":
        g = h.amax(1)
    else:
        a1 = torch.softmax(_dense(p["att1"], h), 1)
        g = (a1 * h).sum(1)
        if v == "ma":
            a2 = torch.softmax(_dense(p["att2"], h), 1)
            g = 0.5 * g + 0.5 * (a2 * h).sum(1)
    return _dense(p["head"], g)


IMAGE_MODELS = {"vgg_tiny": (vgg_tiny_init, vgg_tiny_apply),
                "resnet_tiny": (resnet_tiny_init, resnet_tiny_apply),
                "densenet_tiny": (densenet_tiny_init, densenet_tiny_apply)}
TEXT_MODELS = {"gru_text": (gru_text_init, gru_text_apply),
               "transformer_text": (transformer_text_init,
                                    transformer_text_apply)}
AUDIO_MODELS = {f"crnn_{v}": (functools.partial(crnn_init, variant=v),
                              functools.partial(crnn_apply, variant=v))
                for v in ("ap", "mp", "sa", "ma")}
