"""Weights and token ids made by the benchmark from the seed, on the
device; the weights in the tree the port takes.

The tree's paths and shapes are the port's (``launch/steps.params_shapes``
on the ``meta`` device: nothing drawn or allocated there); every value is
drawn here, one ``torch.Generator`` on the device per leaf, seeded from
the run's seed and the leaf's index, so any one leaf can be made again
alone (``leaf``) and the reference is handed the same numbers. How a leaf
is drawn (ones, a constant, the Mamba decay rates, or a normal scaled by
its fan-in) is the reference family's ``init_rule``.
"""
from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def leaf_seed(seed, index):
    """A generator seed per (run seed, leaf index); any whole seed works."""
    return ((int(seed) * _MIX) ^ (index * 0x2545F4914F6CDD1D + 1)) & _MASK


def shapes(model_cfg, dtype=torch.float32):
    """[(path, shape, dtype)] of the port's params tree for ``model_cfg``."""
    from repro_torch.launch.steps import params_shapes
    from repro_torch.tree import leaves_with_path
    return [(p, tuple(t.shape), t.dtype) for p, t in
            leaves_with_path(params_shapes(model_cfg, dtype))]


def leaf(ref, seed, index, path, shape, dtype, device):
    """Leaf ``index`` of the tree, drawn from the seed."""
    kind, arg = ref.init_rule(path, shape)
    if kind == "normal":
        g = torch.Generator(device=device)
        g.manual_seed(leaf_seed(seed, index))
        t = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return t.mul_(arg).to(dtype)
    if kind == "const":
        return torch.full(shape, arg, dtype=dtype, device=device)
    if kind == "arange_log":             # log(1..n) along the last dim
        row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(shape).contiguous().to(dtype)
    raise ValueError(f"unknown init rule {kind!r} for {path}")


def nest(paths, tensors):
    """The nested tree of ``a/b/0/c`` paths: a dict whose keys are all
    digits is a list."""
    root = {}
    for path, t in zip(paths, tensors):
        *head, last = path.split("/")
        node = root
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def make(ref, table, seed, device):
    """The whole params tree (the port's nesting) drawn from ``seed``."""
    made = [leaf(ref, seed, i, p, s, d, device)
            for i, (p, s, d) in enumerate(table)]
    return nest([p for p, _, _ in table], made)


def tokens(seed, stream, index, shape, vocab, device):
    """Uniform token ids of call ``index`` of a traffic stream (each
    driver its own ``stream``), drawn on the device from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, stream + index))
    return torch.randint(0, vocab, shape, generator=g, device=device)
