"""Batching pipeline: per-participant, per-epoch shuffled batch stacks.

Produces the (K, n_batches, B, ...) arrays the vmapped participant step
consumes. Host-side numpy; deterministic in (seed, round, epoch).

Shards may be *ragged* (unequal lengths — quantity skew, Dirichlet label
skew, or a round-robined remainder). Raggedness is handled with
per-participant batch counts: shard k contributes ``len(shard_k) // B``
real batches per epoch, the stack is padded to the max count ``n_batches``
and :attr:`ParticipantData.batch_mask` marks which ``(k, batch)`` slots are
real. The engines thread that mask through the epoch scan (a masked step is
an identity carry — see ``repro.core.engine``), so no shard is ever clamped
to the global minimum length and no example outside the per-epoch batch
remainder is dropped (the per-epoch shuffle rotates which examples land in
the remainder, so every shard example trains). Padding batches *cycle* the
shard's own permutation — real data, never zeros — so a mask-unaware
consumer degrades to slight oversampling instead of training on garbage.

For equal shards everything reduces bit-for-bit to the classic equal-IID
pipeline: ``ragged`` is False, the mask is all-True, and ``epoch_batches``
returns exactly the arrays it always did.

Elastic membership adds one knob: ``k_max``. Stacked shapes are a
compile-time invariant, so a run that wants standby slots (participants
that may *join* mid-run, see ``repro.core.membership``) must batch for
``K_max`` slots from round 0. ``k_max > len(shards)`` pads the slot list
by cycling the real shards — slot ``K+i`` serves ``shards[i % K]`` — so a
standby slot trains on real data the moment it goes live. The padding
slots are data *views*, not copies, and :meth:`full` still concatenates
each real shard exactly once.
"""
from __future__ import annotations

import numpy as np


class ParticipantData:
    """Holds K disjoint (possibly ragged) shards; yields stacked epoch
    batches plus the validity mask for the padded slots."""

    def __init__(self, shards, batch_size: int, seed: int = 0,
                 k_max=None):
        # shards: list of K lists of arrays, same leading length per k
        #: number of REAL shards (k_max padding slots alias these)
        self.n_shards = len(shards)
        if k_max is not None:
            if k_max < len(shards):
                raise ValueError(
                    f"k_max={k_max} smaller than the {len(shards)} shards")
            shards = list(shards) + [
                shards[i % len(shards)]
                for i in range(k_max - len(shards))]
        self.shards = shards
        self.K = len(shards)
        self.B = batch_size
        self.seed = seed
        #: per-participant example counts (the FedAvg averaging weights)
        self.sizes = tuple(len(s[0]) for s in shards)
        #: per-participant REAL batches per epoch (floor(n_k / B))
        self.batch_counts = tuple(n // batch_size for n in self.sizes)
        if min(self.batch_counts) <= 0:          # survives python -O
            raise ValueError(
                f"shard smaller than one batch: sizes={self.sizes} with "
                f"batch_size={batch_size}")
        self.n_batches = max(self.batch_counts)
        #: True when shards yield unequal batch counts (mask required)
        self.ragged = len(set(self.batch_counts)) > 1

    @property
    def batch_mask(self):
        """(K, n_batches) bool: True where the slot holds one of shard k's
        real per-epoch batches, False on cycled padding slots."""
        return (np.arange(self.n_batches)[None, :]
                < np.asarray(self.batch_counts)[:, None])

    def epoch_batches(self, round_i: int, epoch_j: int):
        """(K, n_batches, B, ...) tuple of arrays for one local epoch.

        Slots beyond shard k's ``batch_counts[k]`` (ragged shards only)
        cycle k's own shuffled examples; pair with :attr:`batch_mask` (the
        engines' identity-carry mask) for exact per-shard epoch semantics.
        """
        out = [[] for _ in self.shards[0]]
        for k, shard in enumerate(self.shards):
            rng = np.random.default_rng(
                (self.seed, k, round_i, epoch_j, 0xC0))
            # np.resize cycles the permutation when a ragged shard needs
            # padding; for n_k >= n_batches*B it is exactly perm[:need]
            perm = np.resize(rng.permutation(len(shard[0])),
                             self.n_batches * self.B)
            for a_i, a in enumerate(shard):
                out[a_i].append(a[perm].reshape(
                    self.n_batches, self.B, *a.shape[1:]))
        return tuple(np.stack(x) for x in out)

    def full(self, k=None):
        """All data of participant k (or concatenated) for evaluation.

        The concatenation covers each REAL shard exactly once — ``k_max``
        padding slots alias real shards and would double-count.
        """
        if k is not None:
            return self.shards[k]
        return [np.concatenate([s[i] for s in self.shards[:self.n_shards]])
                for i in range(len(self.shards[0]))]
