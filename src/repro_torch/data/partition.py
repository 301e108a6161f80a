"""K-way disjoint data partitioning. Participants never see each other's
shard — only parameters cross the WAN.

The paper evaluates the idealized setting ("randomly allocated to 5
participants in an equally distributed manner"), but its central claim is
robustness of model averaging *on different types of data* — so this module
provides the scenario axis as first-class partitioners, each returning K
disjoint index arrays that together cover **every example exactly once**
(property-tested in tests/test_data.py; nothing is silently dropped):

* :func:`partition` — the paper's random split. Equal-IID by default with
  the ``n % K`` remainder distributed round-robin (one extra example to the
  first ``n % K`` shards); ``drop_remainder=True`` restores the exactly-
  equal paper split as a loud opt-in.
* :func:`dirichlet_partition` — label-skew non-IID (the standard federated
  benchmark protocol, cf. FedAvg 1602.05629 / D² 1803.07068): each shard's
  class mixture is drawn from ``Dirichlet(alpha)``; small ``alpha`` gives
  near single-class shards, large ``alpha`` recovers IID.
* :func:`quantity_skew` — unequal shard *sizes* (given as counts or
  fractions), contents IID.

``ParticipantData`` (``repro.data.pipeline``) consumes the resulting ragged
shards with per-participant batch counts + a validity mask, and
``FullAverage(weights=...)`` / ``PartialParticipation`` weight Eq. 2 by the
shard sizes (FedAvg's example-count-weighted generalization).
"""
from __future__ import annotations

import numpy as np


def _assert_exact_cover(idx, n, dropped=0):
    """Every example in exactly one shard (minus the declared drops).

    A plain ``raise`` (not ``assert``) so the no-silent-data-loss guarantee
    survives ``python -O``."""
    all_ids = np.concatenate([np.asarray(i, np.int64) for i in idx]) \
        if idx else np.empty(0, np.int64)
    if len(all_ids) != n - dropped:
        raise ValueError(f"partitioner covered {len(all_ids)} of {n} "
                         f"examples ({dropped} declared drops)")
    if len(np.unique(all_ids)) != len(all_ids):
        raise ValueError("partitioner assigned an example to two shards")


def partition(n: int, K: int, seed: int = 0, *, drop_remainder: bool = False):
    """Random disjoint split into K shards covering all ``n`` examples.

    By default the ``n % K`` remainder is distributed round-robin (the
    first ``n % K`` shards hold one extra example) so no example is ever
    silently dropped. ``drop_remainder=True`` is the paper-faithful
    exactly-equal split — the remainder is *explicitly* discarded.
    Returns a list of K index arrays.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    per, rem = divmod(n, K)
    if drop_remainder:
        out = [perm[k * per:(k + 1) * per] for k in range(K)]
        _assert_exact_cover(out, n, dropped=rem)
        return out
    sizes = [per + (1 if k < rem else 0) for k in range(K)]
    bounds = np.cumsum([0] + sizes)
    out = [perm[bounds[k]:bounds[k + 1]] for k in range(K)]
    _assert_exact_cover(out, n)
    return out


def dirichlet_partition(labels, K: int, alpha: float = 0.5, seed: int = 0,
                        *, min_size: int = 1):
    """Label-skew non-IID split: shard k's class mixture ~ Dirichlet(alpha).

    For every class ``c`` the class's examples are dealt to the K shards in
    proportions drawn from ``Dirichlet(alpha * 1_K)`` (largest-remainder
    rounding, so the class's examples — and hence ALL examples — are covered
    exactly once). ``alpha -> 0`` concentrates each class on few shards;
    ``alpha -> inf`` recovers the IID mixture.

    ``min_size``: after allocation, shards smaller than this are topped up
    deterministically from the largest shards (a tiny-shard guard so a
    downstream batch pipeline always has at least one batch per shard).
    Returns a list of K index arrays.
    """
    labels = np.asarray(labels)
    n = len(labels)
    if not alpha > 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if K * min_size > n:
        raise ValueError(f"cannot give {K} shards >= {min_size} examples "
                         f"each from n={n}")
    rng = np.random.default_rng(seed)
    shards = [[] for _ in range(K)]
    for c in np.unique(labels):
        ids = np.nonzero(labels == c)[0]
        rng.shuffle(ids)
        p = rng.dirichlet(np.full(K, float(alpha)))
        # largest-remainder rounding: counts sum exactly to len(ids)
        raw = p * len(ids)
        counts = np.floor(raw).astype(np.int64)
        short = len(ids) - int(counts.sum())
        if short:
            counts[np.argsort(raw - counts)[::-1][:short]] += 1
        bounds = np.cumsum(np.concatenate([[0], counts]))
        for k in range(K):
            shards[k].append(ids[bounds[k]:bounds[k + 1]])
    out = [np.concatenate(s) if s else np.empty(0, np.int64) for s in shards]
    # deterministic tiny-shard guard: move examples from the largest shards
    while min(len(s) for s in out) < min_size:
        small = int(np.argmin([len(s) for s in out]))
        big = int(np.argmax([len(s) for s in out]))
        out[small] = np.concatenate([out[small], out[big][-1:]])
        out[big] = out[big][:-1]
    out = [rng.permutation(s) for s in out]
    _assert_exact_cover(out, n)
    return out


def quantity_skew(n: int, sizes, seed: int = 0):
    """Unequal-size IID split: shard k gets ``sizes[k]`` examples.

    ``sizes`` is a length-K sequence of absolute counts (summing to ``n``)
    or of fractions (summing to ~1; converted with largest-remainder
    rounding so the counts sum exactly to ``n``). Every shard must end up
    non-empty. Returns a list of K index arrays.
    """
    sizes = np.asarray(sizes, np.float64)
    if sizes.ndim != 1 or len(sizes) == 0:
        raise ValueError("sizes must be a non-empty 1-D sequence")
    if (sizes < 0).any() or not np.isfinite(sizes).all():
        raise ValueError(f"sizes must be finite and >= 0; got {sizes}")
    if np.isclose(sizes.sum(), 1.0) and (sizes <= 1.0).all():
        raw = sizes / sizes.sum() * n
        counts = np.floor(raw).astype(np.int64)
        short = n - int(counts.sum())
        if short:
            counts[np.argsort(raw - counts)[::-1][:short]] += 1
    else:
        counts = sizes.astype(np.int64)
        if (counts != sizes).any():
            raise ValueError(
                f"absolute sizes must be integers; got {sizes}")
        if counts.sum() != n:
            raise ValueError(
                f"sizes sum to {counts.sum()}, expected n={n}")
    if (counts == 0).any():
        raise ValueError(f"every shard must be non-empty; counts={counts}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    bounds = np.cumsum(np.concatenate([[0], counts]))
    out = [perm[bounds[k]:bounds[k + 1]] for k in range(len(counts))]
    _assert_exact_cover(out, n)
    return out


def shard_by_indices(arrays, idx):
    """Apply precomputed shard index arrays to every array of a dataset:
    -> list (per shard) of lists (per array)."""
    return [[a[i] for a in arrays] for i in idx]


def partition_arrays(arrays, K: int, seed: int = 0, *,
                     drop_remainder: bool = False):
    """Random :func:`partition` applied to every array in a tuple/list."""
    n = len(arrays[0])
    return shard_by_indices(arrays, partition(n, K, seed,
                                              drop_remainder=drop_remainder))


def scenario_indices(n: int, K: int, seed: int = 0, *, scenario="iid",
                     labels=None, dirichlet_alpha: float = 0.5, sizes=None,
                     min_size: int = 1, drop_remainder: bool = False):
    """The ONE named-scenario dispatcher shared by every driver
    (``launch/train.py``, ``benchmarks/harness.py``): "iid" |
    "dirichlet" (requires ``labels``) | "sizes" (requires ``sizes``) ->
    K disjoint index arrays from the matching partitioner."""
    if scenario == "iid":
        return partition(n, K, seed, drop_remainder=drop_remainder)
    if scenario == "dirichlet":
        if labels is None:
            raise ValueError("the dirichlet scenario requires labels")
        return dirichlet_partition(labels, K, dirichlet_alpha, seed,
                                   min_size=min_size)
    if scenario == "sizes":
        if sizes is None:
            raise ValueError("the sizes scenario requires sizes")
        return quantity_skew(n, sizes, seed)
    raise ValueError(f"unknown partition scenario {scenario!r}")
