"""Topologies and the gossip aggregators of the port against the JAX
package, on the CPU: every registered topology's matrices (all-live and
live-masked), adjacency, neighbour offsets, edge permutations and
spectral gap bit for bit at several K, the connectivity guard and the
component-split warning; ``RingGossip`` as ``GraphGossip(ring)``, D² as
plain gossip on identical shards, D² with error feedback, under churn and
across quiet trigger rounds; bills that scale with the degree, the
matrix cache; and three-round trajectories of each gossip aggregator in
both engines.

Shaped after ``tests/test_topology.py``. Tolerances: trajectories within
1e-5; matrices, bills and patterns exact.
"""
import math
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import membership as jM
from repro.core import topology as jtopo
from repro.core.colearn import CoLearner as JCoLearner
from repro.launch import train as jtrain
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import membership as tM
from repro_torch.core import topology as ttopo
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves

TOL = {"rtol": 1e-5, "atol": 1e-6}


def jloss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def tloss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def params_np(d=4):
    w = jax.random.normal(jax.random.PRNGKey(0), (d, 1))
    return {"w": np.asarray(w), "b": np.zeros((1,), np.float32)}


def batches_np(K, seed=0, identical=False):
    shape = (1 if identical else K, 3, 8, 4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    x = np.broadcast_to(x, (K,) + shape[1:]).copy()
    return x, x @ np.arange(1.0, 5.0, dtype=np.float32)[:, None]


PKG = {"jax": (japi, jM, JCoLearner, jloss, {},
               lambda t: jax.tree.map(jnp.asarray, t)),
       "torch": (tapi, tM, TCoLearner, tloss, {"device": "cpu"},
                 lambda t: params_from_numpy(t, "cpu"))}


def run(side, make, K=4, rounds=3, engine="python", b=None):
    """``rounds`` rounds of one package's learner; ``make(api, M)``
    returns the strategy keywords."""
    api, M, CL, loss, kw, conv = PKG[side]
    cfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=0.5,
                        max_rounds=rounds + 2)
    eng = api.PythonEngine() if engine == "python" else api.FusedEngine(32)
    learner = CL(cfg, loss, round_engine=eng, **make(api, M), **kw)
    state = learner.init(conv(params_np()))
    data = conv(batches_np(K) if b is None else b)
    for _ in range(rounds):
        state = learner.run_round(state, lambda i, j: data)
    return learner, state


def np_tree(tree):
    return [np.asarray(t, np.float32) for t in leaves(tree)]


def assert_runs_match(js, ts):
    assert [(x.T, x.synced, x.comm_bytes, x.live) for x in js["log"]] == \
        [(x.T, x.synced, x.comm_bytes, x.live) for x in ts["log"]]
    for x, y in zip(js["log"], ts["log"]):
        np.testing.assert_allclose(y.local_losses, x.local_losses, **TOL)
        if np.isfinite(x.rel_change):
            np.testing.assert_allclose(y.rel_change, x.rel_change, **TOL)
    for key in ("params", "prev_avg", "residual"):
        if js.get(key) is None:
            assert ts.get(key) is None
            continue
        for a, b in zip(np_tree(js[key]), np_tree(ts[key]), strict=True):
            np.testing.assert_allclose(b, a, **TOL)


TOPO_CASES = [
    ("ring", {}, (1, 2, 3, 4, 5, 8)),
    ("grid2d", {}, (1, 2, 3, 4, 6, 8, 9)),
    ("torus", {}, (4, 6)),
    ("hypercube", {}, (1, 2, 4, 8)),
    ("exponential", {}, (1, 2, 3, 4, 5, 8)),
    ("erdos_renyi", {"p": 0.9, "seed": 2}, (2, 4, 6)),
    ("complete", {}, (1, 2, 3, 5, 8)),
]


@pytest.mark.parametrize("name,kw,Ks", TOPO_CASES,
                         ids=[c[0] for c in TOPO_CASES])
def test_topology_matrices_match_jax(name, kw, Ks):
    """All-live and live-masked matrices (every live set at K <= 5, a few
    at larger K), adjacency, offsets, edge permutations, period, degree
    and spectral gap equal the JAX package's bit for bit."""
    jt, tt = jtopo.get_topology(name, **kw), ttopo.get_topology(name, **kw)
    rng = np.random.default_rng(0)
    for K in Ks:
        assert tt.validate(K) is tt and tt.period(K) == jt.period(K)
        assert tt.spectral_gap(K) == jt.spectral_gap(K)
        lives = ([np.array([(m >> k) & 1 for k in range(K)], bool)
                  for m in range(1, 2 ** K)] if K <= 5 else
                 [rng.random(K) < 0.6 for _ in range(6)])
        for r in range(tt.period(K) + 1):
            np.testing.assert_array_equal(tt.adjacency(r, K),
                                          jt.adjacency(r, K))
            want = jt.mixing_matrix(r, K)
            got = tt.mixing_matrix(r, K)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert tt.offsets(r, K) == jt.offsets(r, K)
            assert tt.edge_perms(r, K) == jt.edge_perms(r, K)
            assert tt.degree(r, K) == jt.degree(r, K)
            assert tt.in_neighbors(r, K) == jt.in_neighbors(r, K)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for live in lives:
                    if not live.any():
                        continue
                    np.testing.assert_array_equal(
                        tt.mixing_matrix(r, K, live=live),
                        jt.mixing_matrix(r, K, live=live))


def test_connectivity_guard_and_split_warning():
    """The guard rejects a disconnected draw with the reference's message;
    churn that splits a live subgraph warns word for word and mixes
    block-diagonally, as in the JAX package."""
    for topo in (jtopo, ttopo):
        with pytest.raises(ValueError, match="disconnected") as e:
            topo.ErdosRenyiTopology(p=0.05, seed=0).validate(6)
        assert "different seed" in str(e.value)
        with pytest.raises(ValueError, match="power of two"):
            topo.HypercubeTopology().adjacency(0, 6)
        assert topo.is_connected(np.ones((1, 1), bool))
        np.testing.assert_array_equal(
            topo.component_labels(np.eye(3, dtype=bool)), [0, 1, 2])
    msgs = []
    for topo in (jtopo, ttopo):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            W = topo.HypercubeTopology().mixing_matrix(
                0, 4, live=np.array([1, 0, 0, 1], bool))
        msgs.append([str(x.message) for x in w])
        np.testing.assert_array_equal(W, np.eye(4, dtype=np.float32))
    assert msgs[0] == msgs[1] and "component-wise" in msgs[0][0]
    with pytest.raises(ValueError, match="disconnected"):
        run("torch", lambda a, M: {"aggregator": a.GraphGossip(
            ttopo.ErdosRenyiTopology(p=0.05, seed=0))}, rounds=0)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_ring_gossip_is_graph_ring(engine):
    for codec in ("exact", "fused"):
        _, a = run("torch", lambda api, M: {"aggregator": api.RingGossip(),
                                            "codec": codec}, engine=engine)
        _, b = run("torch", lambda api, M: {
            "aggregator": api.GraphGossip("ring"), "codec": codec},
            engine=engine)
        assert all(torch.equal(x, y) for x, y in
                   zip(leaves(a["params"]), leaves(b["params"])))
        assert [x.comm_bytes for x in a["log"]] == \
            [x.comm_bytes for x in b["log"]]
    with pytest.raises(ValueError, match="fixed to the ring"):
        tapi.RingGossip(topology="grid2d")


@pytest.mark.parametrize("tname", ["ring", "grid2d", "complete"])
def test_d2_is_plain_gossip_on_identical_shards(tname):
    """Identical shards keep every local model identical: the correction
    stays (up to the f32 weights' rounding) zero and D² IS gossip,
    exactly for the ring's dyadic weights."""
    b = batches_np(4, identical=True)
    _, g = run("torch", lambda a, M: {"aggregator": a.GraphGossip(tname)},
               b=b)
    _, d = run("torch", lambda a, M: {"aggregator": a.D2Gossip(tname)},
               b=b)
    tol = 0.0 if tname == "ring" else 1e-5
    for x, y in zip(leaves(g["params"]), leaves(d["params"])):
        assert float((x - y).abs().max()) <= tol
    assert max(float(t.abs().max()) for t in leaves(d["residual"])) <= tol


def test_d2_with_error_feedback_composes():
    """The EF residual and the correction ride one slot as ``{"corr",
    "res"}``; a restart zeroes participant k's row of both."""
    learner, state = run("torch", lambda a, M: {
        "aggregator": a.D2Gossip("grid2d"),
        "codec": a.LeafwiseIntN(bits=4, error_feedback=True)},
        engine="fused", rounds=2)
    assert set(state["residual"]) == {"corr", "res"}
    learner.restart_participant(state, 2)
    assert max(float(t[2].abs().max())
               for t in leaves(state["residual"])) == 0.0
    assert max(float(t[0].abs().max())
               for t in leaves(state["residual"])) > 0.0


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_d2_under_churn_freezes_dead_rows(engine):
    """A dead slot's correction (and EF residual) rows are frozen while it
    is down and thaw when it rejoins; the run equals the JAX package's."""
    def make(a, M):
        return {"aggregator": a.D2Gossip("grid2d"),
                "codec": a.LeafwiseIntN(bits=4, error_feedback=True),
                "churn": M.ScriptedChurn(events=(("crash", 2, 1),
                                                 ("rejoin", 4, 1)))}
    learner, state = run("torch", make, rounds=3, engine=engine)
    frozen = [t[1].clone() for t in leaves(state["residual"])]
    data = params_from_numpy(batches_np(4), "cpu")
    state = learner.run_round(state, lambda i, j: data)
    assert all(torch.equal(a, t[1]) for a, t in
               zip(frozen, leaves(state["residual"])))
    state = learner.run_round(state, lambda i, j: data)      # rejoined
    assert [x.live for x in state["log"]] == [4, 4, 3, 3, 4]
    assert_runs_match(run("jax", make, rounds=5, engine=engine)[1], state)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_d2_quiet_trigger_rounds_carry_state(engine):
    """A quiet divergence-trigger round skips the mix: the correction
    passes through it bit for bit."""
    learner, state = run("torch", lambda a, M: {
        "aggregator": a.D2Gossip("grid2d"),
        "sync_policy": a.DivergenceTrigger(delta=0.0)}, rounds=1,
        engine=engine)
    learner.set_sync_policy(tapi.DivergenceTrigger(delta=1e9))
    r0 = [t.clone() for t in leaves(state["residual"])]
    assert max(float(t.abs().max()) for t in r0) > 0
    data = params_from_numpy(batches_np(4), "cpu")
    state = learner.run_round(state, lambda i, j: data)
    assert not state["log"][-1].synced
    assert all(torch.equal(a, b) for a, b in
               zip(r0, leaves(state["residual"])))


def test_bills_scale_with_degree_and_match_jax():
    """Gossip bills O(degree) encoded models a participant: the ring's is
    K-independent, the complete graph's (K-1)-proportional, the
    hypercube's log2(K)-proportional; a sole survivor bills zero; every
    bill equals the JAX package's."""
    for K in (4, 8):
        st = {"w": np.zeros((K, 300), np.float32)}
        ts, js = params_from_numpy(st, "cpu"), jax.tree.map(jnp.asarray, st)
        for codec in ("exact", "leafwise", "fused"):
            tc, jc = tapi.get_codec(codec), japi.get_codec(codec)
            wire = tc.wire_bytes(ts)
            for name, factor in (("ring", 2), ("complete", 2 * (K - 1)),
                                 ("hypercube", 2 * int(math.log2(K))),
                                 ("exponential", 2), ("grid2d", None)):
                bill = tapi.GraphGossip(name).comm_bytes(tc, ts, 1)
                assert bill == japi.GraphGossip(name).comm_bytes(jc, js, 1)
                if factor is not None:
                    assert bill == factor * wire
            assert tapi.RingGossip().comm_bytes(tc, ts, 0) == 2 * wire
    ts = params_from_numpy({"w": np.zeros((4, 64), np.float32)}, "cpu")
    assert tapi.GraphGossip("grid2d").comm_bytes(
        tapi.ExactF32(), ts, 0, live=[1, 0, 0, 0]) == 0


def test_mixing_matrix_cache():
    """A static graph builds its matrix once (read-only); a time-varying
    one keys by the round within its period; live sets key apart; the
    cache holds at most 512 matrices."""
    g = tapi.GraphGossip("grid2d")
    W1 = g.mixing_matrix(0, 6)
    assert W1 is g.mixing_matrix(5, 6) and not W1.flags.writeable
    e = tapi.GraphGossip("exponential")
    assert e.mixing_matrix(0, 8) is e.mixing_matrix(3, 8)      # period 3
    assert e.mixing_matrix(0, 8) is not e.mixing_matrix(1, 8)
    Wl = g.mixing_matrix(0, 6, live=[1, 1, 1, 1, 1, 0])
    assert Wl is not W1 and g.mixing_matrix(0, 6) is W1
    big = tapi.GraphGossip("complete")
    for m in range(1, 600):
        big.mixing_matrix(0, 10, live=[(m >> k) & 1 for k in range(10)])
    assert len(big._mix_cache) <= 512
    assert not e.static_comm and g.static_comm


GOSSIP = {
    "graph-grid2d-exact": lambda a: {"aggregator": a.GraphGossip("grid2d")},
    "graph-exponential-leafwise": lambda a: {
        "aggregator": a.GraphGossip("exponential"), "codec": "leafwise"},
    "graph-hypercube-fused-ef": lambda a: {
        "aggregator": a.GraphGossip("hypercube"),
        "codec": a.FlatFusedIntN(bits=4, error_feedback=True)},
    "ring-leafwise-ef": lambda a: {
        "aggregator": a.RingGossip(),
        "codec": a.LeafwiseIntN(bits=4, error_feedback=True)},
    "d2-ring-leafwise": lambda a: {"aggregator": a.D2Gossip("ring"),
                                   "codec": "leafwise"},
    "d2-complete-fused": lambda a: {"aggregator": a.D2Gossip("complete"),
                                    "codec": "fused"},
}


@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("name", sorted(GOSSIP))
def test_gossip_trajectories_match_jax(engine, name):
    """Three rounds of each gossip aggregator (the time-varying graph, the
    error-feedback codecs, D²) equal the JAX package's."""
    _, js = run("jax", lambda a, M: GOSSIP[name](a), engine=engine)
    _, ts = run("torch", lambda a, M: GOSSIP[name](a), engine=engine)
    assert_runs_match(js, ts)


def test_aggregator_registry_names():
    assert isinstance(tapi.get_aggregator("graph"), tapi.GraphGossip)
    assert isinstance(tapi.get_aggregator("d2"), tapi.D2Gossip)
    assert isinstance(tapi.get_aggregator("ring"), tapi.RingGossip)
    for spec, kw in (("graph", {"topology": "hypercube"}),
                     ("d2", {"topology": "grid2d"}), ("ring", {})):
        assert (tapi.get_aggregator(spec, **kw).name
                == japi.get_aggregator(spec, **kw).name)
    assert set(ttopo.TOPOLOGIES) == set(jtopo.TOPOLOGIES)
    with pytest.raises(KeyError, match="unknown topology"):
        ttopo.get_topology("nope")


def test_train_cli_gossip_flags_print_the_jax_fields(capsys):
    """``--aggregator d2 --topology exponential`` (the time-varying graph
    under D²): the data-independent fields of every round line equal the
    JAX CLI's; the port's two engines print the same lines, ``--aggregator
    graph --topology erdos_renyi --er-p`` runs, and the topology flags'
    parse-time errors match."""
    base = ["--participants", "4", "--rounds", "2", "--t0", "1",
            "--n-examples", "64", "--batch-size", "4", "--seq-len", "16",
            "--steps-per-epoch", "2", "--codec", "leafwise"]
    line = re.compile(r"^round (\d+): T=(\d+) lr (\S+) rel_dw=\S+ "
                      r"local_loss=\S+ eval=\S+ (comm=.*) \(")
    flags = ["--aggregator", "d2", "--topology", "exponential"]
    outs = []
    for main, extra in ((ttrain.main, ["--device", "cpu"]),
                        (ttrain.main, ["--device", "cpu", "--engine",
                                       "python"]),
                        (jtrain.main, [])):
        assert main(base + flags + extra) == 0
        outs.append([line.match(x).groups() for x in
                     capsys.readouterr().out.splitlines()
                     if x.startswith("round ")])
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == 2
    assert ttrain.main(base + ["--aggregator", "graph", "--topology",
                               "erdos_renyi", "--er-p", "0.9",
                               "--device", "cpu"]) == 0
    assert "aggregator=graph[erdos_renyi]" in capsys.readouterr().out
    for flags in (["--er-p", "0.3"], ["--topology", "grid2d"]):
        for main, extra in ((ttrain.main, ["--device", "cpu"]),
                            (jtrain.main, [])):
            with pytest.raises(SystemExit):
                main(base + flags + extra)
    capsys.readouterr()
