"""Streaming non-stationary shards: the continuous-operation data layer,
ported from ``repro/data/stream.py`` (numpy only, so the port keeps its
own copy; snapshots, epoch batches and drifted test sets equal the JAX
package's bit for bit).

The paper's data centers keep *producing* data while training runs; the
static ``ParticipantData`` stack models a frozen snapshot of that stream.
``ShardStream`` models the stream itself: ``snapshot(round)`` yields a
fresh per-round ``ParticipantData`` over the (possibly drifted) corpus, so
every communication round trains on that round's data instead of round 0's.

Concept drift is a scenario axis: a ``DriftSchedule`` decides HOW the
stream moves, as a pure function of ``(seed, round)`` — two streams built
from the same arguments replay bit-identical histories, which is what
makes resume-from-checkpoint exact (the round index *is* the stream
position).

* :class:`NoDrift` — the static stream. ``is_static`` keeps the stream on
  the frozen-stack path: ``snapshot(r)`` returns the ONE round-0
  ``ParticipantData`` for every round, so a no-drift stream is bit for bit
  the classic pipeline.
* :class:`CovariateDrift` — gradual input-distribution rotation. Float
  inputs are rotated in fixed random feature 2-planes by an angle growing
  ``rate`` per round (an exact orthogonal transform — labels untouched);
  integer token inputs swap a growing fraction of fixed random vocab
  pairs. Round 0 is the identity.
* :class:`LabelShift` — per-round re-skew of WHICH shard sees which
  labels: the class preference of each shard rotates with the round
  (``rate`` revolutions per round), and examples are re-dealt into
  fixed-size shards by circular class-to-shard affinity. Contents are
  untouched; only the assignment drifts.
* :class:`AbruptDrift` — a task switch at ``at_round``: from that round
  on, a ``severity`` fraction of the label space is cyclically relabeled
  (y -> roll(y)); before it, the stream is the static one.

Every snapshot re-partitions/re-transforms on the host, but the *shapes*
``(K, n_batches, B, ...)`` are a round-0 invariant (guarded in
:meth:`ShardStream.snapshot`): the fused engine copies each round's new
contents into the static inputs of its captured round graph, so a
drifting stream never captures again.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data import partition as part_mod
from repro_torch.data.pipeline import ParticipantData


# ---------------------------------------------------------------------------
# Drift schedules
# ---------------------------------------------------------------------------
class DriftSchedule:
    """How the stream moves. Pure in ``(seed, round)``; stateless."""

    name = "drift"
    #: True => the stream is frozen and ShardStream must stay bit-for-bit
    #: on the static-stack code path (one snapshot, reused every round)
    is_static = False
    #: True => the schedule re-deals examples to shards per round
    #: (assignment drift); False => the round-0 assignment is reused
    reassigns = False

    def transform(self, x, y, round_i, seed):
        """Content drift: corpus ``(x, y)`` as seen at ``round_i``."""
        return x, y

    def assign(self, labels, sizes, K, round_i, seed):
        """Assignment drift: K index arrays of exactly ``sizes`` lengths
        covering every example once (only called when ``reassigns``)."""
        raise NotImplementedError


class NoDrift(DriftSchedule):
    """The frozen stream (the pre-stream pipeline, bit-for-bit)."""

    name = "none"
    is_static = True


class CovariateDrift(DriftSchedule):
    """Gradual input-distribution shift, ``rate`` radians (float inputs)
    or vocab-pair-fraction (int inputs) per round. Labels untouched."""

    name = "covariate"

    def __init__(self, rate: float = 0.1):
        if not rate >= 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        self.rate = float(rate)

    def transform(self, x, y, round_i, seed):
        if round_i == 0 or self.rate == 0:
            return x, y
        rng = np.random.default_rng((seed, 0xC0D1))  # round-INdependent
        if np.issubdtype(x.dtype, np.floating):
            # rotate fixed random feature 2-planes by theta = rate * round:
            # an exact orthogonal transform of the input space, smoothly
            # leaving the training distribution as rounds advance
            theta = self.rate * round_i
            flat = x.reshape(len(x), -1)
            d = flat.shape[1]
            perm = rng.permutation(d)
            a, b = perm[: d // 2], perm[d // 2: 2 * (d // 2)]
            out = flat.copy()
            ca, sa = np.cos(theta), np.sin(theta)
            out[:, a] = ca * flat[:, a] - sa * flat[:, b]
            out[:, b] = sa * flat[:, a] + ca * flat[:, b]
            return out.reshape(x.shape).astype(x.dtype), y
        # integer tokens: swap a growing fraction of fixed random vocab
        # pairs (identity at round 0, full pair swap at rate*round >= 1)
        vocab = int(x.max()) + 1
        pairs = rng.permutation(vocab)
        n_pairs = vocab // 2
        n_swap = min(n_pairs, int(self.rate * round_i * n_pairs))
        if n_swap == 0:
            return x, y
        lut = np.arange(vocab)
        a, b = pairs[:n_swap], pairs[n_pairs:n_pairs + n_swap]
        lut[a], lut[b] = b, a
        return lut[x].astype(x.dtype), y


class LabelShift(DriftSchedule):
    """Per-round re-skew of the shard<-label assignment: shard k's
    preferred classes rotate with the round. Contents untouched."""

    name = "label_shift"
    reassigns = True

    def __init__(self, rate: float = 0.1, temperature: float = 0.0):
        if not rate >= 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        self.rate = float(rate)
        #: optional angular jitter per (seed, round) draw — 0 keeps the
        #: rotation purely deterministic geometry
        self.temperature = float(temperature)

    def assign(self, labels, sizes, K, round_i, seed):
        labels = np.asarray(labels)
        n = len(labels)
        classes, inv = np.unique(labels, return_inverse=True)
        C = len(classes)
        rng = np.random.default_rng((seed, round_i, 0x5817))
        # class c sits at angle 2*pi*c/C; shard k's preference center
        # rotates by `rate` revolutions per round
        class_angle = 2 * np.pi * inv / C
        out = []
        remaining = np.ones(n, bool)
        order = rng.permutation(n)  # deterministic tie-break within class
        for k in range(K):
            center = 2 * np.pi * (k / K + self.rate * round_i)
            if self.temperature:
                center += self.temperature * rng.normal()
            # circular distance of every example's class to the center
            d = np.angle(np.exp(1j * (class_angle - center)))
            score = np.abs(d)[order] + np.where(remaining[order], 0, np.inf)
            take = order[np.argsort(score, kind="stable")[: sizes[k]]]
            remaining[take] = False
            out.append(take)
        part_mod._assert_exact_cover(out, n)
        return out


class AbruptDrift(DriftSchedule):
    """Task switch at ``at_round``: a ``severity`` fraction of the label
    space is cyclically relabeled from that round on."""

    name = "abrupt"

    def __init__(self, at_round: int = 3, severity: float = 1.0):
        if at_round < 0:
            raise ValueError(f"at_round must be >= 0, got {at_round}")
        if not 0 <= severity <= 1:
            raise ValueError(f"severity must be in [0, 1], got {severity}")
        self.at_round = int(at_round)
        self.severity = float(severity)

    def transform(self, x, y, round_i, seed):
        if round_i < self.at_round or self.severity == 0:
            return x, y
        classes = np.unique(y)
        n_moved = int(round(self.severity * len(classes)))
        if n_moved < 2:
            return x, y
        # cycle the first `n_moved` classes (a full cycle has no fixed
        # point: every affected class maps to a different one)
        moved = classes[:n_moved]
        lut = np.arange(int(classes.max()) + 1)
        lut[moved] = np.roll(moved, -1)
        return x, lut[y].astype(y.dtype)


#: drift registry — the scenario axis, like partitioners / churn schedules
DRIFTS = {"none": NoDrift, "covariate": CovariateDrift,
          "label_shift": LabelShift, "abrupt": AbruptDrift}


def get_drift(spec=None, **kw) -> DriftSchedule:
    """None -> NoDrift(); a name -> ``DRIFTS[name](**kw)``; an object (any
    DriftSchedule-shaped instance) passes through."""
    if spec is None:
        return NoDrift()
    if isinstance(spec, str):
        if spec not in DRIFTS:
            raise ValueError(f"unknown drift {spec!r}; "
                             f"registered: {sorted(DRIFTS)}")
        return DRIFTS[spec](**kw)
    if kw:
        raise ValueError("drift kwargs only apply to registry names")
    return spec


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------
class ShardStream:
    """Per-round ``ParticipantData`` snapshots over a drifting corpus.

    Mirrors the ``ParticipantData`` surface (``sizes`` / ``batch_counts``
    / ``batch_mask`` / ``ragged`` / ``epoch_batches(round, epoch)``), so
    every consumer of the static stack (``CoLearner.run_round``'s
    ``epoch_batches_fn``, the harness, ``launch/train.py``) can take a
    stream instead without touching the engines. Shapes are a round-0
    invariant; contents are whatever the drift schedule says round ``r``
    looks like.

    ``partition_labels``: the labels the (re-)partitioners skew over.
    Defaults to ``y`` when 1-D (classification) else the coarse
    first-target-token proxy ``y[:, 0] % 10`` (the ``launch/train.py``
    convention for LM corpora).
    """

    def __init__(self, train, K: int, batch_size: int, seed: int = 0, *,
                 drift=None, partition: str = "iid", dirichlet_alpha=1.0,
                 sizes=None, k_max=None, drop_remainder: bool = False,
                 partition_labels=None):
        self.arrays = [np.asarray(a) for a in train]
        self.K = K
        self.B = batch_size
        self.seed = seed
        self.drift = get_drift(drift)
        self.k_max = k_max
        y = self.arrays[-1]
        if partition_labels is not None:
            self._labels = np.asarray(partition_labels)
        else:
            self._labels = y if y.ndim == 1 else y[:, 0] % 10
        n = len(self.arrays[0])
        #: the round-0 assignment, reused every round unless the drift
        #: schedule re-deals (exact coverage asserted by the partitioner)
        self._base_idx = part_mod.scenario_indices(
            n, K, seed, scenario=partition, labels=self._labels,
            dirichlet_alpha=dirichlet_alpha, sizes=sizes,
            min_size=batch_size, drop_remainder=drop_remainder)
        self._base_sizes = tuple(len(i) for i in self._base_idx)
        self._cache = (-1, None)
        base = self.snapshot(0)
        # delegate the static-shape surface (a capture-time invariant)
        self.sizes = base.sizes
        self.batch_counts = base.batch_counts
        self.n_batches = base.n_batches
        self.ragged = base.ragged
        self.n_shards = base.n_shards

    @property
    def batch_mask(self):
        return self.snapshot(0).batch_mask

    def snapshot(self, round_i: int) -> ParticipantData:
        """The stream as staged for round ``round_i``. Pure in
        ``(constructor args, round_i)``; consecutive calls are cached."""
        if self.drift.is_static:
            round_i = 0                      # ONE snapshot, every round
        if self._cache[0] == round_i:
            return self._cache[1]
        x, y = self.drift.transform(self.arrays[0], self.arrays[-1],
                                    round_i, self.seed)
        arrays = [x, *self.arrays[1:-1], y]
        if self.drift.reassigns and round_i > 0:
            idx = self.drift.assign(self._labels, self._base_sizes, self.K,
                                    round_i, self.seed)
        else:
            idx = self._base_idx
        pd = ParticipantData(part_mod.shard_by_indices(arrays, idx),
                             self.B, self.seed, k_max=self.k_max)
        if hasattr(self, "sizes") and (
                pd.sizes != self.sizes
                or pd.batch_counts != self.batch_counts):
            raise ValueError(
                f"drift {self.drift.name!r} changed shard shapes at "
                f"round {round_i}: sizes {pd.sizes} != {self.sizes} — "
                "shapes are a compile-time invariant of the stream")
        self._cache = (round_i, pd)
        return pd

    def epoch_batches(self, round_i: int, epoch_j: int):
        """(K, n_batches, B, ...) arrays for one local epoch of the
        round's snapshot — the drop-in ``ParticipantData`` signature."""
        return self.snapshot(round_i).epoch_batches(round_i, epoch_j)

    def transform_test(self, test, round_i: int):
        """The held-out arrays as the round-``round_i`` distribution sees
        them (content drift only — assignment drift never moves the global
        distribution). The honest eval set for round ``round_i``."""
        x, y = self.drift.transform(np.asarray(test[0]), np.asarray(test[-1]),
                                    round_i, self.seed)
        return (x, *[np.asarray(a) for a in test[1:-1]], y)

    def full(self, k=None, round_i: int = 0):
        return self.snapshot(round_i).full(k)
