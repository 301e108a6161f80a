"""Ensemble-learning baseline (paper Table 2), ported from
``repro/core/ensemble.py``.

Each participant trains independently on its disjoint shard (no parameter
exchange); at inference the *outputs* (post-softmax probabilities) are
averaged. JAX's ``vmap`` over the stacked participant axis is a loop over
its K slices here.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def ensemble_logits(predict_fn, stacked_params, batch):
    """predict_fn(params, batch) -> logits. Averages probabilities over K
    and returns ``log(max(mean, 1e-9))``."""
    K = leaves(stacked_params)[0].shape[0]
    probs = torch.stack([torch.softmax(predict_fn(
        tree_map(lambda t, _k=k: t[_k], stacked_params), batch).float(), -1)
        for k in range(K)])
    return torch.log(torch.clamp(probs.mean(0), min=1e-9))


def ensemble_accuracy(predict_fn, stacked_params, batch, labels):
    lp = ensemble_logits(predict_fn, stacked_params, batch)
    return (torch.argmax(lp, -1) == labels).float().mean()
