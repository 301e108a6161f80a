"""Round-state checkpoints across the two packages, on the CPU: a churned
D² run with error feedback saved by the JAX package's
``save_round_state`` resumes in the port (and the reverse) and equals the
uninterrupted run within 1e-5; the legacy fallbacks (no optimizer file,
no membership, two-field history, no shared model) restore as the JAX
package restores them; and a port checkpoint restored under the fused
engine is bit-identical to the uninterrupted run, written into the
learner's own storage so that no graph is captured again.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import membership as jM
from repro.core.colearn import CoLearner as JCoLearner
from repro_torch.checkpoint import io as tio
from repro_torch.core import api as tapi
from repro_torch.core import membership as tM
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.tree import leaves

TOL = {"rtol": 1e-5, "atol": 1e-6}
K = 4
EVENTS = (("crash", 1, 1), ("rejoin", 3, 1))


def jloss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def tloss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def params_np():
    w = jax.random.normal(jax.random.PRNGKey(0), (4, 300))
    return {"w": np.asarray(w), "b": np.zeros((300,), np.float32)}


def batches_np():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (K, 2, 8, 4)))
    return x, np.tanh(x @ np.ones((4, 300), np.float32))


def learner(side, engine="python", codec="leafwise-ef", optimizer="sgd"):
    """A fresh learner and its init state: D² over the ring under scripted
    churn, with a 4-bit error-feedback codec (leafwise or flat)."""
    api, M, CL, loss, kw = ((japi, jM, JCoLearner, jloss, {})
                            if side == "jax" else
                            (tapi, tM, TCoLearner, tloss,
                             {"device": "cpu"}))
    cls = api.LeafwiseIntN if codec == "leafwise-ef" else api.FlatFusedIntN
    cfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=1e-9,
                        max_rounds=6)
    eng = api.PythonEngine() if engine == "python" else api.FusedEngine(32)
    ln = CL(cfg, loss, optimizer_name=optimizer, round_engine=eng,
            codec=cls(bits=4, error_feedback=True),
            aggregator=api.D2Gossip("ring"),
            churn=M.ScriptedChurn(events=EVENTS), **kw)
    conv = ((lambda t: jax.tree.map(jnp.asarray, t)) if side == "jax"
            else (lambda t: tio.params_from_numpy(t, "cpu")))
    return ln, ln.init(conv(params_np())), conv(batches_np())


def rounds(ln, state, data, n):
    for _ in range(n):
        state = ln.run_round(state, lambda i, j: data)
    return state


def np_tree(tree):
    return [np.asarray(t, np.float32) for t in leaves(tree)]


def assert_states_close(a, b, **tol):
    for key in ("params", "prev_avg", "residual", "opt"):
        for x, y in zip(np_tree(a[key]), np_tree(b[key]), strict=True):
            np.testing.assert_allclose(y, x, **(tol or TOL))
    assert (a["membership"].live, a["membership"].events) == \
        (b["membership"].live, b["membership"].events)
    assert (a["round"], a["global_epoch"]) == (b["round"], b["global_epoch"])
    assert a["ctrl"].T == b["ctrl"].T
    for x, y in zip(a["log"][-2:], b["log"][-2:]):
        np.testing.assert_allclose(y.local_losses, x.local_losses, **TOL)
        assert (x.comm_bytes, x.live) == (y.comm_bytes, y.live)


@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("codec", ["leafwise-ef", "flat-ef"])
def test_jax_checkpoint_resumes_in_torch(tmp_path, engine, codec):
    """Saved by the JAX package after round 2 (slot 1 dead, the D²
    correction and EF residual live), restored into a fresh port learner:
    rounds 3 and 4 (the rejoin) equal the JAX uninterrupted run."""
    jl, js, jd = learner("jax", engine, codec)
    ref = rounds(jl, js, jd, 4)
    jl, js, jd = learner("jax", engine, codec)
    js = rounds(jl, js, jd, 2)
    path = str(tmp_path / "ck")
    jio.save_round_state(path, js)
    tl, ts, td = learner("torch", engine, codec)
    ts = tio.restore_round_state(path, ts)
    assert ts["membership"].live == (True, False, True, True)
    ts["log"] = list(js["log"])
    assert_states_close(ref, rounds(tl, ts, td, 2))


def test_torch_checkpoint_resumes_in_jax(tmp_path):
    tl, ts, td = learner("torch", "fused")
    ref = rounds(tl, ts, td, 4)
    tl, ts, td = learner("torch", "fused")
    ts = rounds(tl, ts, td, 2)
    path = str(tmp_path / "ck")
    tio.save_round_state(path, ts)
    meta = json.load(open(path + ".meta.json"))
    assert meta["membership"]["events"] == [[1, 1, "leave"]]
    assert meta["has_residual"] and meta["has_prev_avg"] and meta["has_opt"]
    jl, js, jd = learner("jax", "fused")
    js = jio.restore_round_state(path, js)
    js["log"] = list(ts["log"])
    assert_states_close(ref, rounds(jl, js, jd, 2))


def test_legacy_checkpoints_restore_as_jax(tmp_path):
    """No optimizer file (the caller's optimizer state stays), no
    membership (all live), two-field ``(rel, T)`` history (the round index
    is its position), no residual flag (the caller's zero residual), no
    shared model (None): the port's restore equals the JAX package's."""
    tl, ts, td = learner("torch", optimizer="momentum")
    ts = rounds(tl, ts, td, 2)
    path = str(tmp_path / "legacy")
    tio.save_round_state(path, ts)
    meta = json.load(open(path + ".meta.json"))
    for key in ("has_opt", "membership", "has_residual", "has_prev_avg"):
        meta.pop(key)
    meta["history"] = [h[1:] for h in meta["history"]]
    json.dump(meta, open(path + ".meta.json", "w"))
    jl, js, _ = learner("jax", optimizer="momentum")
    js = jio.restore_round_state(path, js)
    tl2, ts2, _ = learner("torch", optimizer="momentum")
    opt0 = [t.clone() for t in leaves(ts2["opt"])]
    ts2 = tio.restore_round_state(path, ts2)
    assert ts2["prev_avg"] is None and js["prev_avg"] is None
    assert ts2["membership"] == tM.Membership.all_live(K)
    assert js["membership"] == jM.Membership.all_live(K)
    assert ts2["ctrl"].history == js["ctrl"].history == (
        (0, float("inf"), 1), (1, ts["ctrl"].history[1][1], 1))
    assert all(torch.equal(a, b) for a, b in zip(opt0, leaves(ts2["opt"])))
    assert max(float(t.abs().max()) for t in leaves(ts2["residual"])) == 0
    for x, y in zip(np_tree(js["params"]), np_tree(ts2["params"])):
        np.testing.assert_array_equal(x, y)


def test_torch_restore_is_bit_exact_with_no_recapture(tmp_path):
    """Saved after round 2 and restored into the SAME fused learner after
    it ran on (the captured graphs read the restored storage), and into a
    fresh one: rounds 3 and 4 equal the uninterrupted run bit for bit,
    and the first learner captures nothing new."""
    tl, ts, td = learner("torch", "fused")
    ref = rounds(tl, ts, td, 4)
    tl, ts, td = learner("torch", "fused")
    ts = rounds(tl, ts, td, 2)
    path = str(tmp_path / "ck")
    tio.save_round_state(path, ts)
    ptrs = [t.data_ptr() for k in ("params", "residual", "prev_avg")
            for t in leaves(ts[k])]
    ts = rounds(tl, ts, td, 1)
    captures = tl._runner.graphs.captures
    ts = tio.restore_round_state(path, ts)
    ts["log"] = ts["log"][:2]
    assert [t.data_ptr() for k in ("params", "residual", "prev_avg")
            for t in leaves(ts[k])] == ptrs
    ts = rounds(tl, ts, td, 2)
    assert tl._runner.graphs.captures == captures
    fl, fs, _ = learner("torch", "fused")
    fs = rounds(fl, tio.restore_round_state(path, fs), td, 2)
    for st in (ts, fs):
        for key in ("params", "residual", "prev_avg"):
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(ref[key]), leaves(st[key])))
        assert st["membership"] == ref["membership"]
        assert [x.local_losses for x in st["log"][-2:]] == \
            [x.local_losses for x in ref["log"][-2:]]
