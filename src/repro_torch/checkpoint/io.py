"""Weight bridge and the path-keyed npz checkpoint format.

The on-disk format is ``repro/checkpoint/io.py``'s: one npz entry per
leaf, keyed by the leaf's path (dict keys and list indices joined with
``/``); a bfloat16 leaf is stored as its uint16 bit pattern under
``<path>::bf16``. A checkpoint written by either package restores in the
other.

``params_from_numpy`` / ``params_to_numpy`` move a nested tree between
numpy and torch. Both COPY: the port updates parameters in place, so a
tensor must never alias a caller's numpy buffer (``torch.from_numpy``
would).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.device import resolve_device

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


def _to_tensor(arr, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # ml_dtypes array from JAX
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.tensor(bits).view(torch.bfloat16).to(device)
    return torch.tensor(np.ascontiguousarray(arr),
                        dtype=_NP_TO_TORCH[arr.dtype], device=device)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def params_from_numpy(tree, device=None):
    """Nested tree of numpy arrays -> same tree of fresh tensors."""
    dev = resolve_device(device)
    return tree_mod.tree_map(lambda a: _to_tensor(a, dev), tree)


def params_to_numpy(tree):
    """Nested tree of tensors -> same tree of fresh numpy arrays."""
    return tree_mod.tree_map(_to_numpy, tree)


def _flatten(tree):
    flat = {}
    for key, leaf in tree_mod.leaves_with_path(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:       # npz can't hold bfloat16
            flat[key + "::bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat


def save_pytree(path: str, tree):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def restore_pytree(path: str, like):
    """Restore into the structure of ``like`` (shape and dtype validated);
    the result lies on ``like``'s devices."""
    with np.load(path) as data:
        flat = dict(data)
    out = []
    for key, leaf in tree_mod.leaves_with_path(like):
        if key + "::bf16" in flat:
            bits = np.ascontiguousarray(flat[key + "::bf16"]).view(np.int16)
            t = torch.tensor(bits).view(torch.bfloat16)
        elif key in flat:
            t = torch.tensor(flat[key])
        else:
            raise KeyError(f"checkpoint missing {key}")
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree_mod.unflatten_like(like, out)
