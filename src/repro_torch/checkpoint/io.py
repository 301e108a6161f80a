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

``save_round_state`` / ``restore_round_state`` persist a learner's round
state in the reference's on-disk format: ``<path>.params.npz``,
``.opt.npz``, ``.prev_avg.npz`` and ``.residual.npz`` (the error-feedback
residual and/or the D² correction), and ``<path>.meta.json`` with the
round, the global epoch, the sync policy's T, history and skipped rounds,
and the membership. A round state saved by either package restores in
the other. Restore writes INTO the learner's existing tensors, so a fused
runner's captured graphs stay valid.
"""
from __future__ import annotations

import json
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


@torch.no_grad()
def _restore_into(path, tree):
    """Read a pytree checkpoint and copy it INTO ``tree``'s tensors (their
    storage is kept: a captured graph reads it by address)."""
    for dst, src in zip(tree_mod.leaves(tree),
                        tree_mod.leaves(restore_pytree(path, tree))):
        dst.copy_(src)
    return tree


def save_round_state(path: str, state):
    """Persist the co-learning round state: params, the per-participant
    optimizer state, the last synced shared model ``prev_avg`` (after a
    quiet round the slots hold drifted locals, so it is not recoverable
    from the params), the round state (``residual``) and the sync policy's
    and membership's host state."""
    save_pytree(path + ".params.npz", state["params"])
    save_pytree(path + ".opt.npz", state["opt"])
    if state.get("prev_avg") is not None:
        save_pytree(path + ".prev_avg.npz", state["prev_avg"])
    if state.get("residual") is not None:
        save_pytree(path + ".residual.npz", state["residual"])
    ctrl = state["ctrl"]
    meta = {"round": state["round"], "global_epoch": state["global_epoch"],
            "T": ctrl.T, "history": [list(h) for h in ctrl.history],
            "skipped": list(getattr(ctrl, "skipped", ())),
            "has_prev_avg": state.get("prev_avg") is not None,
            "has_residual": state.get("residual") is not None,
            "has_opt": True}
    mem = state.get("membership")
    if mem is not None:
        meta["membership"] = {
            "live": [bool(a) for a in mem.live],
            "events": [[int(r), int(k), str(kind)]
                       for r, k, kind in mem.events]}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def restore_round_state(path: str, state):
    """Restore a round state saved by ``save_round_state`` (of either
    package) into ``state`` (a learner's ``init`` state or a running one),
    writing every tensor into the storage ``state`` already holds.

    Legacy checkpoints fall back as the reference's do: no optimizer file
    keeps the caller's optimizer state, no membership restores all-live,
    two-field ``(rel, T)`` history entries gain their round index, no
    residual keeps the caller's (zero) round state, no ``prev_avg`` resets
    it to None (the next round's rel is inf)."""
    from repro_torch.core.api import SyncState
    from repro_torch.core.membership import Membership
    _restore_into(path + ".params.npz", state["params"])
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("has_opt"):
        _restore_into(path + ".opt.npz", state["opt"])
    state["round"] = meta["round"]
    state["global_epoch"] = meta["global_epoch"]
    history = tuple(
        h if len(h) == 3 else (idx, *h)
        for idx, h in enumerate(tuple(h) for h in meta["history"]))
    state["ctrl"] = SyncState(meta["T"], history,
                              tuple(meta.get("skipped", ())))
    mm = meta.get("membership")
    if mm is not None:
        state["membership"] = Membership(
            live=tuple(bool(a) for a in mm["live"]),
            events=tuple((int(r), int(k), str(kind))
                         for r, k, kind in mm["events"]))
    else:
        K = tree_mod.leaves(state["params"])[0].shape[0]
        state["membership"] = Membership.all_live(K)
    if meta.get("has_residual") and state.get("residual") is not None:
        _restore_into(path + ".residual.npz", state["residual"])
    if meta.get("has_prev_avg"):
        if state.get("prev_avg") is not None:
            _restore_into(path + ".prev_avg.npz", state["prev_avg"])
        else:
            like = tree_mod.tree_map(lambda t: t[0], state["params"])
            state["prev_avg"] = restore_pytree(path + ".prev_avg.npz", like)
    else:
        state["prev_avg"] = None
    return state
