"""The port's streaming data layer (``repro_torch.data.stream``) against the
JAX package's (``repro.data.stream``), on the CPU.

A port of ``tests/test_serving.py``'s drift and stream tests, run against
both packages: drift determinism in ``(seed, round)``, that each drift
moves what it says, the registry, the stream's round-0 shape invariants
and exact coverage, the shape guard, and the no-drift stream as the frozen
pipeline. Both modules are numpy only, so every snapshot, epoch batch and
drifted test set must equal the JAX package's bit for bit, for all four
drifts and rounds 0-4, on float features (ragged shards) and on integer
LM tokens.
"""
import numpy as np
import pytest

from repro.data import stream as jstream
from repro.data.pipeline import ParticipantData as JParticipantData
from repro_torch.data import partition as part_mod
from repro_torch.data import stream as tstream
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples


def cls_data(n=48, d=4, C=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, C, size=n).astype(np.int64)
    return x, y


def drifts(mod):
    return {"none": mod.NoDrift(), "covariate": mod.CovariateDrift(rate=0.2),
            "label_shift": mod.LabelShift(rate=0.25),
            "abrupt": mod.AbruptDrift(at_round=2)}


def arrays_equal(a, b):
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


# --- the drift schedules -----------------------------------------------------
@pytest.mark.parametrize("name", ["covariate", "label_shift", "abrupt"])
def test_drift_deterministic_in_seed_round_and_equal_to_jax(name):
    x, y = cls_data(n=60)
    drift, jdrift = drifts(tstream)[name], drifts(jstream)[name]
    for r in (0, 1, 3):
        a = drift.transform(x, y, r, seed=5)
        assert arrays_equal(a, drift.transform(x, y, r, seed=5))
        assert arrays_equal(a, jdrift.transform(x, y, r, seed=5))
        if drift.reassigns:
            ia = drift.assign(y, (30, 30), 2, r, seed=5)
            assert arrays_equal(ia, drift.assign(y, (30, 30), 2, r, seed=5))
            assert arrays_equal(ia, jdrift.assign(y, (30, 30), 2, r,
                                                  seed=5))


def test_drift_actually_drifts():
    x, y = cls_data(n=60)
    cx, _ = tstream.CovariateDrift(rate=0.2).transform(x, y, 3, seed=0)
    assert not np.array_equal(cx, x)
    # int tokens drift by vocab-pair swap, preserving dtype
    xi = np.random.default_rng(0).integers(0, 32, (40, 8)).astype(np.int32)
    ci, _ = tstream.CovariateDrift(rate=0.5).transform(xi, y[:40], 4, seed=0)
    assert ci.dtype == xi.dtype and not np.array_equal(ci, xi)
    jci, _ = jstream.CovariateDrift(rate=0.5).transform(xi, y[:40], 4, seed=0)
    assert np.array_equal(ci, jci)
    # abrupt: identity before at_round, full-cycle relabel after
    ad = tstream.AbruptDrift(at_round=2, severity=1.0)
    _, y0 = ad.transform(x, y, 1, seed=0)
    assert np.array_equal(y0, y)
    _, y2 = ad.transform(x, y, 2, seed=0)
    assert not np.any(y2 == y)
    assert set(np.unique(y2)) == set(np.unique(y))
    # label shift: round 1 re-deal differs from the round-0 assignment
    ls = tstream.LabelShift(rate=0.25)
    i1 = ls.assign(y, (30, 30), 2, 1, seed=0)
    i0 = ls.assign(y, (30, 30), 2, 0, seed=0)
    assert not all(np.array_equal(a, b) for a, b in zip(i0, i1))


def test_get_drift_registry_matches_jax():
    assert sorted(tstream.DRIFTS) == sorted(jstream.DRIFTS)
    assert isinstance(tstream.get_drift(None), tstream.NoDrift)
    d = tstream.get_drift("covariate", rate=0.3)
    assert isinstance(d, tstream.CovariateDrift) and d.rate == 0.3
    d = tstream.AbruptDrift(at_round=1)
    assert tstream.get_drift(d) is d
    for mod in (tstream, jstream):
        with pytest.raises(ValueError, match="unknown drift"):
            mod.get_drift("nope")
        with pytest.raises(ValueError, match="registry names"):
            mod.get_drift(d, rate=0.5)
        for bad in (lambda: mod.CovariateDrift(rate=-1),
                    lambda: mod.LabelShift(rate=-1),
                    lambda: mod.AbruptDrift(at_round=-1),
                    lambda: mod.AbruptDrift(severity=2)):
            with pytest.raises(ValueError):
                bad()


# --- the stream --------------------------------------------------------------
@pytest.mark.parametrize("name", ["none", "covariate", "label_shift",
                                  "abrupt"])
def test_stream_invariants_every_round(name):
    x, y = cls_data(n=50)                # 25 a shard: 3 batches + 1
    drift = drifts(tstream)[name]
    stream = tstream.ShardStream([x, y], 2, 8, seed=3, drift=drift)
    mask0 = np.asarray(stream.batch_mask)
    for r in range(5):
        pd = stream.snapshot(r)
        assert pd.sizes == stream.sizes
        assert pd.batch_counts == stream.batch_counts
        assert np.array_equal(np.asarray(pd.batch_mask), mask0)
        dx, dy = drift.transform(x, y, r, stream.seed)
        got = np.sort(np.concatenate(
            [np.asarray(pd.full(k)[1]) for k in range(2)]))
        assert np.array_equal(got, np.sort(dy))
        assert sum(pd.sizes) == len(x)


@pytest.mark.parametrize("data", ["float_ragged", "lm_tokens"])
@pytest.mark.parametrize("name", ["none", "covariate", "label_shift",
                                  "abrupt"])
def test_snapshots_equal_jax_bit_for_bit(name, data):
    """Rounds 0-4: each snapshot's shards, sizes, batch counts and mask,
    two epochs' batches and the drifted test set equal the JAX stream's."""
    if data == "float_ragged":
        x, y = cls_data(n=53)            # shards of 27 and 26 over B=3
        K, B, test = 2, 3, cls_data(n=20, seed=1)
    else:
        x, y = lm_examples(0, 60, 8, 64)
        K, B, test = 3, 4, lm_examples(99, 16, 8, 64)
    t = tstream.ShardStream([x, y], K, B, seed=3,
                            drift=drifts(tstream)[name])
    j = jstream.ShardStream([x, y], K, B, seed=3,
                            drift=drifts(jstream)[name])
    assert t.ragged == (data == "float_ragged")
    assert (t.sizes, t.batch_counts, t.n_batches, t.ragged, t.n_shards) == (
        j.sizes, j.batch_counts, j.n_batches, j.ragged, j.n_shards)
    moved = False
    for r in range(5):
        tp, jp = t.snapshot(r), j.snapshot(r)
        assert isinstance(tp, ParticipantData)
        assert isinstance(jp, JParticipantData)
        assert np.array_equal(np.asarray(tp.batch_mask),
                              np.asarray(jp.batch_mask))
        for k in range(K):
            assert arrays_equal(tp.full(k), jp.full(k))
        for e in (0, 1):
            assert arrays_equal(t.epoch_batches(r, e), j.epoch_batches(r, e))
        assert arrays_equal(t.transform_test(test, r),
                            j.transform_test(test, r))
        moved |= not arrays_equal(tp.full(0), t.snapshot(0).full(0))
    # every drift but none moves the stream within rounds 0-4
    assert moved == (name != "none")


@pytest.mark.parametrize("mod", [tstream, jstream], ids=["torch", "jax"])
def test_stream_shape_guard_raises(mod):
    class BadDrift(mod.DriftSchedule):
        name = "bad"
        reassigns = True

        def assign(self, labels, sizes, K, round_i, seed):
            # legal cover, WRONG per-shard sizes from round 1 on
            n = len(labels)
            cut = sizes[0] + (0 if round_i == 0 else 4)
            return [np.arange(cut), np.arange(cut, n)]

    x, y = cls_data(n=48)
    stream = mod.ShardStream([x, y], 2, 8, drift=BadDrift())
    stream.snapshot(0)
    with pytest.raises(ValueError, match="changed shard shapes"):
        stream.snapshot(1)


def test_nodrift_bit_identical_to_static_pipeline():
    x, y = cls_data(n=48)
    stream = tstream.ShardStream([x, y], 2, 8, seed=1)
    idx = part_mod.scenario_indices(len(x), 2, 1, scenario="iid", labels=y,
                                    min_size=8)
    static = ParticipantData(part_mod.shard_by_indices([x, y], idx), 8, 1)
    assert stream.snapshot(0) is stream.snapshot(3)   # ONE snapshot, cached
    for r, e in [(0, 0), (1, 0), (2, 1)]:
        assert arrays_equal(stream.epoch_batches(r, e),
                            static.epoch_batches(r, e))
