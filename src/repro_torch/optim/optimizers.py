"""Hand-built optimizers, ported from ``repro/optim/optimizers.py``.

API mirrors the JAX package: ``init(params) -> state``,
``update(grads, state, params, lr) -> (updates, new_state)`` and
``apply_updates(params, updates)``. The learning rate is passed per call
because the paper's CLR schedule changes it every local epoch (Eq. 3).

Updates are f32 and added as ``p + (-lr * g)`` in that order, not
``add_(g, alpha=-lr)``, so the rounding matches the JAX update. These
functions return new tensors; the round engine (``core/engine.py``)
writes them into the stacked parameter storage IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree):
    """‖tree‖₂ over every leaf, accumulated in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` by ``min(1, max_norm / max(‖grads‖, 1e-9))``; each
    leaf keeps its dtype (new tensors)."""
    gn = global_norm(grads)
    # a divide by a 0-d tensor (``scalar / tensor`` multiplies by the
    # reciprocal)
    num = torch.as_tensor(max_norm, dtype=torch.float32, device=gn.device)
    scale = torch.clamp(num / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


class SGD:
    """Plain SGD — the paper's local optimizer ("localSGD", Algorithm 1)."""

    def init(self, params):
        return ()

    def update(self, grads, state, params, lr):
        return tree_map(lambda g: -lr * g.float(), grads), state


class Momentum:
    def __init__(self, beta=0.9):
        self.beta = beta

    def init(self, params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def update(self, grads, state, params, lr):
        new_m = tree_map(lambda m, g: self.beta * m + g.float(), state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m


class AdamW:
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        dev = leaves(params)[0].device
        return {"m": z, "v": tree_map(torch.clone, z),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: self.b2 * v
                     + (1 - self.b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - self.b1 ** t.float()
        bc2 = 1 - self.b2 ** t.float()
        upd = tree_map(
            lambda m, v, p: -lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                                   + self.wd * p.float()),
            m, v, params)
        return upd, {"m": m, "v": v, "t": t}


def get_optimizer(name: str, *, momentum=0.9, weight_decay=0.0):
    if name == "sgd":
        return SGD()
    if name == "momentum":
        return Momentum(momentum)
    if name == "adamw":
        return AdamW(weight_decay=weight_decay)
    raise KeyError(name)


def apply_updates(params, updates):
    """``p + u`` in f32, cast back to the parameter's dtype (new tensors)."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
