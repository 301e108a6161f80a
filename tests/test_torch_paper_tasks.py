"""The paper-task harness: ``repro_torch.paper_tasks`` against
``benchmarks/harness.py`` from the same JAX-initialised params.

Small sizes (n = 320 training examples, K = 5, ``steps_cap`` 2, 3 rounds):
per-round losses, ``rel``, T and LR within 1e-5, ``comm_bytes`` and the
shard sizes exact, accuracies within one test example (one example's
argmax may sit on a 1e-6 tie). Co-learning runs cover both engines and the
exact, fused int8 (K3's plain version) and leaf-wise int8 codecs over
resnet_tiny, gru_text and crnn_ma; vanilla, ensemble, a weighted Dirichlet
split, churn and drift run on resnet_tiny. The two scripts' ``check()``
smokes pass on the CPU.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import membership as jmem
from repro.data import stream as jstream
from repro.data.synthetic import audio_like, image_like, text_like
from repro.models import convnets as jcn
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import membership as tmem
from repro_torch.data import stream as tstream
from repro_torch.models import convnets as tcn
from repro_torch.paper_tasks import harness as th

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import harness as jh  # noqa: E402

N, N_TEST, K, ROUNDS, CAP = 320, 100, 5, 3, 2
TOL = {"rtol": 1e-5, "atol": 1e-5}
DATA = {"image": image_like, "text": text_like, "audio": audio_like}
TASK = {"resnet_tiny": ("image", jcn.IMAGE_MODELS, tcn.IMAGE_MODELS),
        "gru_text": ("text", jcn.TEXT_MODELS, tcn.TEXT_MODELS),
        "crnn_ma": ("audio", jcn.AUDIO_MODELS, tcn.AUDIO_MODELS)}


@pytest.fixture(scope="module")
def setup():
    """Per model: the train/test arrays, the JAX init as numpy and both
    packages' (init_fn, apply_fn) starting from it."""
    out = {}
    for name, (task, jm, tm) in TASK.items():
        train = DATA[task](seed=0, n=N)
        test = DATA[task](seed=1000, n=N_TEST)
        p_np = jax.tree.map(np.asarray, jm[name][0](jax.random.PRNGKey(0)))
        out[name] = {
            "train": train, "test": test,
            "jax": (lambda key, _p=p_np: jax.tree.map(jnp.asarray, _p),
                    jax.jit(jm[name][1])),
            "torch": (lambda gen, _p=p_np: params_from_numpy(_p, "cpu"),
                      tm[name][1])}
    return out


def _both(setup, name, fn, **kw):
    s = setup[name]
    jr = getattr(jh, fn)(*s["jax"], s["train"], s["test"], **kw)
    tr = getattr(th, fn)(*s["torch"], s["train"], s["test"], device="cpu",
                         **kw)
    return jr, tr


def _accs_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert abs(x - y) <= 1.0 / N_TEST + 1e-9, (a, b)


def _check(jr, tr, rounds=ROUNDS):
    jl, tl = jr["state"]["log"], tr["state"]["log"]
    assert len(jl) == len(tl) == rounds
    for a, b in zip(jl, tl):
        assert (a.round, a.T, a.comm_bytes, a.synced, a.live) == (
            b.round, b.T, b.comm_bytes, b.synced, b.live)
        np.testing.assert_allclose(b.local_losses, a.local_losses, **TOL)
        np.testing.assert_allclose([b.lr_first, b.lr_last],
                                   [a.lr_first, a.lr_last], **TOL)
        if np.isinf(a.rel_change):
            assert np.isinf(b.rel_change)
        else:
            np.testing.assert_allclose(b.rel_change, a.rel_change, **TOL)
    assert jr["T"] == tr["T"] and jr["live"] == tr["live"]
    assert tuple(jr["shard_sizes"]) == tuple(tr["shard_sizes"])
    for key in ("comm_bytes", "total_comm_bytes", "synced_rounds"):
        assert jr[key] == tr[key], key
    assert len(jr["history"]) == len(tr["history"])
    for a, b in zip(jr["history"], tr["history"]):
        assert (a[0], a[2]) == (b[0], b[2])
    _accs_close(jr["acc"], tr["acc"])
    assert set(tr) == set(jr)
    # both trained
    assert np.mean(tl[-1].local_losses) < np.mean(tl[0].local_losses)


# every (codec, engine) pair once, spread over the three model families
CASES = [("resnet_tiny", "python", None), ("resnet_tiny", "fused", "fused"),
         ("resnet_tiny", "fused", "leafwise"), ("gru_text", "fused", None),
         ("gru_text", "python", "leafwise"), ("crnn_ma", "python", "fused")]


@pytest.mark.parametrize("name,engine,codec", CASES)
def test_colearn_matches_jax(setup, name, engine, codec):
    jr, tr = _both(setup, name, "run_colearn", K=K, rounds=ROUNDS, T0=1,
                   epsilon=0.03, steps_cap=CAP, engine=engine, codec=codec)
    _check(jr, tr)


def test_vanilla_matches_jax(setup):
    jr, tr = _both(setup, "resnet_tiny", "run_vanilla", epochs=ROUNDS)
    _check(jr, tr)


def test_ensemble_matches_jax(setup):
    jr, tr = _both(setup, "resnet_tiny", "run_ensemble", K=K, epochs=2,
                   steps_cap=CAP)
    assert set(jr) == set(tr) == {"acc", "local_acc"}
    _accs_close([jr["acc"]], [tr["acc"]])
    _accs_close(jr["local_acc"], tr["local_acc"])
    assert len(tr["local_acc"]) == K


def test_weighted_dirichlet_matches_jax(setup):
    jr, tr = _both(setup, "resnet_tiny", "run_colearn", K=K, rounds=ROUNDS,
                   steps_cap=CAP, engine="fused", partition="dirichlet",
                   dirichlet_alpha=0.5, weighted=True)
    _check(jr, tr)
    sizes = tr["shard_sizes"]
    assert sum(sizes) == N and len(set(sizes)) > 1      # ragged, covered
    assert tr["learner"].aggregator.weights == tuple(sizes)


def test_churn_matches_jax(setup):
    events = (("crash", 1, 2), ("rejoin", 2, 2))
    s = setup["resnet_tiny"]
    kw = dict(K=K, rounds=ROUNDS, steps_cap=CAP, engine="fused",
              codec="leafwise")
    jr = jh.run_colearn(*s["jax"], s["train"], s["test"],
                        churn=jmem.ScriptedChurn(events=events), **kw)
    tr = th.run_colearn(*s["torch"], s["train"], s["test"], device="cpu",
                        churn=tmem.ScriptedChurn(events=events), **kw)
    _check(jr, tr)
    assert tr["live"] == [K, K - 1, K]


def test_drift_matches_jax(setup):
    s = setup["resnet_tiny"]
    kw = dict(K=K, rounds=ROUNDS, steps_cap=CAP, engine="python")
    jr = jh.run_colearn(*s["jax"], s["train"], s["test"],
                        drift=jstream.AbruptDrift(at_round=1), **kw)
    tr = th.run_colearn(*s["torch"], s["train"], s["test"], device="cpu",
                        drift=tstream.AbruptDrift(at_round=1), **kw)
    _check(jr, tr)


def test_harness_drift_plumbing(setup):
    """run_colearn(drift=...) stages the stream and scores the drifted
    test set; stream= passes a prebuilt one; not both."""
    s = setup["resnet_tiny"]
    (x, y), test = s["train"], s["test"]
    kw = dict(K=2, rounds=2, T0=1, batch_size=8, steps_cap=1,
              engine="fused", device="cpu")
    r = th.run_colearn(*s["torch"], (x, y), test,
                       drift=tstream.AbruptDrift(at_round=1), **kw)
    assert len(r["acc"]) == 2 and all(np.isfinite(a) for a in r["acc"])
    stream = tstream.ShardStream([x, y], 2, 8, seed=0,
                                 drift=tstream.CovariateDrift(0.2))
    r2 = th.run_colearn(*s["torch"], (x, y), test, stream=stream, **kw)
    assert len(r2["acc"]) == 2
    with pytest.raises(ValueError, match="not both"):
        th.run_colearn(*s["torch"], (x, y), test, K=2, rounds=1,
                       drift=tstream.AbruptDrift(), stream=stream,
                       device="cpu")
    with pytest.raises(ValueError, match="not both"):
        th.run_colearn(*s["torch"], (x, y), test, K=2, rounds=1,
                       codec="fused", compress="fused", device="cpu")


def test_init_fn_gets_a_seeded_generator_on_the_device():
    seen = []

    def init_fn(gen):
        seen.append((gen.device.type, gen.initial_seed()))
        return tcn.resnet_tiny_init(gen)
    x, y = image_like(seed=0, n=64)
    th.run_colearn(init_fn, tcn.resnet_tiny_apply, (x, y), (x, y), K=2,
                   rounds=1, batch_size=16, steps_cap=1, seed=7,
                   device="cpu")
    assert seen == [("cpu", 7)]


def test_cifar_like_check_on_cpu(capsys):
    from repro_torch.paper_tasks import cifar_like
    assert cifar_like.check(device="cpu") == 0
    assert "cifar_like --check OK" in capsys.readouterr().out


def test_ablation_check_on_cpu(capsys):
    from repro_torch.paper_tasks import ablation
    assert ablation.check(quiet=True, device="cpu") == 0
    assert "ablation --check OK" in capsys.readouterr().out
