"""ModelBank: versioned publication of trained models into serving.

Ported from ``repro/serving/bank.py``. After each communication round the
learner *publishes* its shared model (or, for the paper's Table 2
ensemble baseline, the whole per-participant stack) into the bank;
serving loops *poll* the bank and hot-swap to the newest version between
batches. Publication is a single reference assignment of a fully built
snapshot, so a reader never observes a half-updated model; versions are
strictly monotonic.

Staleness is first-class metadata: every snapshot records the round and
global epoch it was trained through and whether that round synced, and
``staleness(state_round)`` reports how many rounds the serving copy lags
the learner. ``publish_on="synced"`` (the default) keeps the bank on the
last *synced* shared model through quiet rounds; ``publish_on="always"``
is the ensemble-baseline mode, where the local replicas are what gets
served.

Persistence rides ``repro_torch.checkpoint.io``, in the JAX package's
on-disk format: ``dir=`` makes every publish also write
``v<version>.npz`` and ``v<version>.meta.json``, and :meth:`ModelBank.load`
restores the newest version into a fresh bank, whichever package wrote it.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Any

import torch

from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.core import ensemble as ensemble_mod
from repro_torch.tree import tree_map

#: publication modes: "shared" = the synced shared model (one replica);
#: "ensemble" = the whole (K,)-stacked participant params, served through
#: ``core.ensemble`` output averaging (paper Table 2 baseline)
MODES = ("shared", "ensemble")


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """One published model: immutable params + staleness metadata. A
    snapshot from :meth:`ModelBank.publish_from` owns copies of the
    learner's params (the port's engines update those in place);
    ``publish(params)`` takes the caller's tensors as given, so the caller
    must not update them in place afterwards."""

    version: int
    params: Any
    round: int              # rounds completed when published
    global_epoch: int
    synced: bool            # did the publishing round communicate
    mode: str               # "shared" | "ensemble"
    published_at: float     # host wall-clock (time.time())


class ModelBank:
    """Monotonic-versioned model publication with atomic swap."""

    def __init__(self, mode: str = "shared", publish_on: str = "synced",
                 dir: str | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
        if publish_on not in ("synced", "always"):
            raise ValueError(f"publish_on must be 'synced' or 'always', "
                             f"got {publish_on!r}")
        self.mode = mode
        self.publish_on = publish_on
        self.dir = dir
        self._current: ModelSnapshot | None = None

    # -- write side ---------------------------------------------------------
    def publish(self, params, *, round_i: int, global_epoch: int = 0,
                synced: bool = True) -> ModelSnapshot:
        """Publish ``params`` as the next version (atomic swap)."""
        snap = ModelSnapshot(
            version=self.version + 1, params=params, round=round_i,
            global_epoch=global_epoch, synced=synced, mode=self.mode,
            published_at=time.time())
        if self.dir is not None:
            self._persist(snap)
        self._current = snap
        return snap

    def publish_from(self, learner, state) -> ModelSnapshot | None:
        """Snapshot the learner's round-``state`` into the bank. Returns
        the new snapshot, or None when the round was quiet and
        ``publish_on="synced"``."""
        log = state["log"][-1] if state["log"] else None
        synced = log.synced if log is not None else True
        if self.publish_on == "synced" and not synced:
            return None
        # copies: the learner's tensors are trained and mixed in place
        # (``shared_model`` clones the shared row)
        params = (tree_map(lambda t: t.clone(), state["params"])
                  if self.mode == "ensemble"
                  else learner.shared_model(state))
        return self.publish(params, round_i=state["round"],
                            global_epoch=state["global_epoch"],
                            synced=synced)

    # -- read side ----------------------------------------------------------
    def current(self) -> ModelSnapshot | None:
        return self._current

    @property
    def version(self) -> int:
        return 0 if self._current is None else self._current.version

    def staleness(self, state_round: int) -> int:
        """Rounds the serving copy lags the learner (1e9 before the first
        publish)."""
        if self._current is None:
            return int(1e9)
        return max(0, int(state_round) - self._current.round)

    # -- serving-path inference ---------------------------------------------
    def predict_logits(self, predict_fn, batch):
        """Log-probabilities of the CURRENT snapshot for ``batch``:
        ``core.ensemble.ensemble_logits`` over the stacked params in
        ensemble mode, a plain log-softmax of one forward otherwise."""
        snap = self._current
        if snap is None:
            raise RuntimeError("ModelBank is empty — nothing published yet")
        if snap.mode == "ensemble":
            return ensemble_mod.ensemble_logits(predict_fn, snap.params,
                                                batch)
        return torch.log_softmax(predict_fn(snap.params, batch).float(), -1)

    def accuracy(self, predict_fn, batch, labels):
        """Serving-path accuracy of the current snapshot (either mode)."""
        lp = self.predict_logits(predict_fn, batch)
        return (torch.argmax(lp, -1) == labels).float().mean()

    # -- persistence (checkpoint/io-backed) ----------------------------------
    def _persist(self, snap: ModelSnapshot):
        os.makedirs(self.dir, exist_ok=True)
        save_pytree(os.path.join(self.dir, f"v{snap.version}.npz"),
                    snap.params)
        meta = {"version": snap.version, "round": snap.round,
                "global_epoch": snap.global_epoch, "synced": snap.synced,
                "mode": snap.mode, "published_at": snap.published_at}
        with open(os.path.join(self.dir,
                               f"v{snap.version}.meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, dir: str, like, publish_on: str = "synced") -> "ModelBank":
        """Restore the newest persisted version into a fresh bank.

        ``like`` is a params tree of the published structure (shared model
        or stacked, matching the persisted mode); the restored params take
        its devices and dtypes."""
        metas = glob.glob(os.path.join(dir, "v*.meta.json"))
        if not metas:
            raise FileNotFoundError(f"no published versions under {dir}")
        with open(max(metas, key=lambda p: int(
                os.path.basename(p)[1:].split(".")[0]))) as f:
            meta = json.load(f)
        bank = cls(mode=meta["mode"], publish_on=publish_on, dir=dir)
        params = restore_pytree(
            os.path.join(dir, f"v{meta['version']}.npz"), like)
        bank._current = ModelSnapshot(
            version=meta["version"], params=params, round=meta["round"],
            global_epoch=meta["global_epoch"], synced=meta["synced"],
            mode=meta["mode"], published_at=meta["published_at"])
        return bank
