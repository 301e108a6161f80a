"""Plain PyTorch reference of a co-learning round (the paper's Algorithm 1
with Eq. 2 over a quantising wire): from one shared model, each of K
participants in turn takes its SGD steps on its own batches (``p - lr *
grad`` of the family's loss), sends its model through the wire codec
(``wire.roundtrip``), and the shared model becomes the mean of what the K
sent. One participant is held at a time, so a round needs the shared
model, the running sum, one participant's model and its gradients.

``params`` is any nesting of dicts and lists of tensors; the family
module (``bench/reference/<family>.py``) gives ``loss(params, arch,
tokens, labels, low)``.
"""
from __future__ import annotations

import torch

from bench.reference import wire


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: tree_rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_rebuild(t, it) for t in tree]
    return next(it)


def with_leaves(tree, new):
    return tree_rebuild(tree, iter(new))


def run_round(family, params, arch, batches, *, participants, steps, lr,
              block, bits, low=False, average=True):
    """One round from the shared model ``params`` (not modified).
    ``batches(k, s)`` gives participant k's step-s (tokens, labels).
    Returns (the new shared model, the mean loss over every participant
    and step, the norm of each leaf's gradient at participant 0's first
    step). ``average=False`` leaves Eq. 2 out (participant 0's model
    becomes the shared one): a fault the check must see."""
    shared = tree_leaves(params)
    acc = [torch.zeros_like(t) for t in shared]
    losses, first = [], None
    kept = None
    for k in range(participants):
        own = [t.detach().clone() for t in shared]
        for s in range(steps):
            tokens, labels = batches(k, s)
            own = [t.requires_grad_(True) for t in own]
            loss = family.loss(with_leaves(params, own), arch, tokens,
                               labels, low)
            grads = torch.autograd.grad(loss, own)
            if first is None:
                first = [float(torch.linalg.vector_norm(g, dtype=torch.float64))
                         for g in grads]
            with torch.no_grad():
                own = [t.detach() + (-lr) * g for t, g in zip(own, grads)]
            del grads
            losses.append(float(loss.detach()))
        with torch.no_grad():
            if not average and k == 0:
                kept = own
            for a, t in zip(acc, own):
                a.add_(wire.roundtrip(t, block, bits))
        del own
    with torch.no_grad():
        K = torch.tensor(float(participants), device=shared[0].device)
        new = kept if kept is not None else [a / K for a in acc]
    return with_leaves(params, new), sum(losses) / len(losses), first
