"""Deterministic synthetic datasets (the offline stand-ins for CIFAR-10 /
Toxic-comments / Google-commands — see DESIGN.md §1: the paper's *systems*
claims are validated exactly; accuracy-parity claims are validated on these
teacher-generated tasks of the same three modalities).

All generators are pure functions of a seed.
"""
from __future__ import annotations

import numpy as np


def _teacher_warp(rng, x, width=64, depth=2):
    """Fixed random MLP warp so classes are not linearly separable."""
    d = x.shape[-1]
    h = x
    for _ in range(depth):
        w = rng.normal(size=(h.shape[-1], width)) / np.sqrt(h.shape[-1])
        h = np.tanh(h @ w)
    w = rng.normal(size=(width, d)) / np.sqrt(width)
    return h @ w + 0.1 * x


def image_like(seed=0, n=6000, n_classes=10, hw=16, channels=3, noise=1.0):
    """CIFAR-10 analog: smooth class templates + pixel noise. Returns
    (x:(n,hw,hw,c) f32, y:(n,) i32). Templates are low-frequency (conv-net
    learnable); noise keeps the task non-trivial (~70-90% achievable)."""
    rng = np.random.default_rng(seed)
    # class templates come from a FIXED rng: every seed (train/test split)
    # must share the same classes — only sampling noise varies with `seed`
    rng_cls = np.random.default_rng(0xC1A55)
    y = rng.integers(0, n_classes, size=n)
    # low-frequency templates: random coarse 4x4 patterns upsampled
    coarse = 2.0 * rng_cls.normal(size=(n_classes, 4, 4, channels))
    templates = coarse.repeat(hw // 4, axis=1).repeat(hw // 4, axis=2)
    x = templates[y] + noise * rng.normal(size=(n, hw, hw, channels))
    x = x / x.std()                      # normalized inputs (stable SGD)
    return x.astype(np.float32), y.astype(np.int32)


def text_like(seed=0, n=6000, n_classes=6, seq_len=32, vocab=128):
    """Toxic-comments analog: class defined by planted class-specific bigrams
    in an otherwise random token stream. Returns (x:(n,S) i32, y:(n,) i32)."""
    rng = np.random.default_rng(seed + 1)
    # class-reserved marker tokens (disjoint from the noise-token range)
    markers = np.arange(n_classes * 3).reshape(n_classes, 3) % vocab
    y = rng.integers(0, n_classes, size=n)
    x = rng.integers(n_classes * 3, vocab, size=(n, seq_len))
    for i in range(n):
        pos = rng.integers(0, seq_len - 3)
        x[i, pos:pos + 3] = markers[y[i]]
    return x.astype(np.int32), y.astype(np.int32)


def audio_like(seed=0, n=6000, n_classes=10, frames=24, mels=32):
    """Speech-commands analog: class-dependent spectro-temporal patterns.
    Returns (x:(n,frames,mels) f32, y:(n,) i32)."""
    rng = np.random.default_rng(seed + 2)
    y = rng.integers(0, n_classes, size=n)
    t = np.linspace(0, 1, frames)[None, :, None]
    m = np.linspace(0, 1, mels)[None, None, :]
    f0 = (1 + y[:, None, None]) * 2.0
    chirp = np.sin(2 * np.pi * f0 * t * (1 + m))           # class chirp
    x = chirp + 0.8 * rng.normal(size=(n, frames, mels))
    return x.astype(np.float32), y.astype(np.int32)


def lm_tokens(seed=0, n_tokens=2 ** 16, vocab=256, order=2):
    """Synthetic language: sparse random Markov chain (learnable structure).
    Returns a (n_tokens,) int32 stream."""
    rng = np.random.default_rng(seed + 3)
    n_ctx = vocab ** order if vocab ** order <= 65536 else 65536
    trans = rng.dirichlet(np.full(8, 0.5), size=n_ctx)      # 8 likely nexts
    nexts = rng.integers(0, vocab, size=(n_ctx, 8))
    out = np.empty(n_tokens, np.int32)
    ctx = 0
    for i in range(n_tokens):
        row = ctx % n_ctx
        out[i] = nexts[row, rng.choice(8, p=trans[row])]
        ctx = (ctx * vocab + int(out[i])) % n_ctx
    return out


def lm_examples(seed=0, n=2048, seq_len=64, vocab=256):
    """(tokens:(n,S), labels:(n,S)) next-token pairs from the Markov stream."""
    stream = lm_tokens(seed, n * (seq_len + 1) + 1, vocab)
    xs = np.stack([stream[i * (seq_len + 1):(i + 1) * (seq_len + 1)]
                   for i in range(n)])
    return xs[:, :-1].astype(np.int32), xs[:, 1:].astype(np.int32)
