"""Elastic membership in the port against the JAX package, on the CPU:
``core/membership.py`` (the ``Membership`` step and log, scripted and
random churn traces draw for draw), the liveness row through both round
engines (all-live runs bit-identical to the static path, a dead slot an
identity carry, a rejoin warm-started from the sync reference), the
live-renormalised mixing matrices and bills, the live divergence, the
sync policies' reading of membership events, ``RoundLog.live``, ``k_max``
standby slots, the naive-membership ablation and the CLI's flags.

Shaped after ``tests/test_membership.py``: the tiny linear model, its
params and batches drawn from seeds, the same numpy inputs on both sides.
Tolerances: trajectories (losses, params, rel) within 1e-5; traces,
matrices, bills, live counts and sync patterns exact.
"""
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import membership as jM
from repro.core import schedule as jsched
from repro.core.colearn import CoLearner as JCoLearner
from repro.data.pipeline import ParticipantData as JData
from repro.launch import train as jtrain
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import membership as tM
from repro_torch.core import schedule as tsched
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.data.pipeline import ParticipantData as TData
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves

TOL = {"rtol": 1e-5, "atol": 1e-6}


def jloss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def tloss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def params_np(key=0, d=4):
    w = jax.random.normal(jax.random.PRNGKey(key), (d, 1))
    return {"w": np.asarray(w), "b": np.zeros((1,), np.float32)}


def batches_np(K, n_batches=3, B=2, d=4, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (K, n_batches, B, d))
    return np.asarray(x), np.asarray(x @ jnp.arange(1.0, d + 1)[:, None])


J = SimpleNamespace(api=japi, M=jM, CL=JCoLearner, loss=jloss, kw={},
                    conv=lambda t: jax.tree.map(jnp.asarray, t))
T = SimpleNamespace(api=tapi, M=tM, CL=TCoLearner, loss=tloss,
                    kw={"device": "cpu"},
                    conv=lambda t: params_from_numpy(t, "cpu"))


def run(pkg, K=4, rounds=4, engine="python", make=lambda p: {}, b=None,
        optimizer="sgd", T0=1, epsilon=1e-9):
    """``rounds`` rounds of one package's learner; ``make(pkg)`` returns
    the strategy keywords (churn, codec, aggregator, ...)."""
    cfg = CoLearnConfig(n_participants=K, T0=T0, eta0=0.05,
                        epsilon=epsilon, max_rounds=rounds + 1)
    eng = (pkg.api.PythonEngine() if engine == "python"
           else pkg.api.FusedEngine(32))
    learner = pkg.CL(cfg, pkg.loss, optimizer_name=optimizer,
                     round_engine=eng, **make(pkg), **pkg.kw)
    state = learner.init(pkg.conv(params_np()))
    data = pkg.conv(batches_np(K) if b is None else b)
    for _ in range(rounds):
        state = learner.run_round(state, lambda i, j: data)
    return learner, state


def np_tree(tree):
    """The leaves of a JAX or torch tree (one order) as f32 numpy."""
    return [np.asarray(t, np.float32) for t in leaves(tree)]


def assert_trees_close(a, b, **tol):
    for x, y in zip(np_tree(a), np_tree(b), strict=True):
        np.testing.assert_allclose(y, x, **(tol or TOL))


def assert_runs_match(js, ts):
    jl, tl = js["log"], ts["log"]
    assert [(x.T, x.synced, x.comm_bytes, x.live) for x in jl] == \
        [(x.T, x.synced, x.comm_bytes, x.live) for x in tl]
    for x, y in zip(jl, tl):
        np.testing.assert_allclose(y.local_losses, x.local_losses, **TOL)
        if np.isfinite(x.rel_change):
            np.testing.assert_allclose(y.rel_change, x.rel_change, **TOL)
    jm, tm = js["membership"], ts["membership"]
    assert (jm.live, jm.events) == (tm.live, tm.events)
    assert_trees_close(js["params"], ts["params"])
    assert_trees_close(js["prev_avg"], ts["prev_avg"])
    if js.get("residual") is not None:
        assert_trees_close(js["residual"], ts["residual"])


# --- Membership and the churn schedules ----------------------------------------
def test_membership_step_and_log():
    for M in (jM, tM):
        m = M.Membership.all_live(4).step(1, [True, False, True, True])
        m = m.step(2, np.array([True, True, False, True]))
        assert m.events == ((1, 1, "leave"), (2, 1, "join"), (2, 2, "leave"))
        assert m.round_events(2) == ((2, 1, "join"), (2, 2, "leave"))
        assert m.joined(2) == (1,) and m.n_live == 3 and m.k_max == 4
        assert m.live_slots() == (0, 1, 3)
        np.testing.assert_array_equal(m.live_mask(), [1, 1, 0, 1])
        with pytest.raises(ValueError, match="K_max=4"):
            m.step(3, [True, True])
    tm = tM.Membership.all_live(3).step(0, [1, 0, 1])
    jm = jM.Membership.all_live(3).step(0, [1, 0, 1])
    assert (tm.live, tm.events) == (jm.live, jm.events)


@pytest.mark.parametrize("seed,K", [(0, 3), (7, 5), (123, 8)])
def test_churn_traces_match_jax(seed, K):
    """Scripted (events, flaky slots, standby) and random traces equal the
    JAX package's round for round; errors and the registry agree."""
    events = (("crash", 1, K - 1), ("rejoin", 3, K - 1), ("crash", 2, 0))
    for kw in ({"events": events},
               {"events": events, "flaky": ((1, 4),)},
               {"events": (("rejoin", 2, K - 1),), "initial_live": K - 1}):
        js, ts = jM.ScriptedChurn(**kw), tM.ScriptedChurn(**kw)
        assert js.is_static == ts.is_static is False
        for r in range(8):
            np.testing.assert_array_equal(ts.live_mask(r, K),
                                          js.live_mask(r, K))
    for kw in ({"p_fail": 0.3, "p_join": 0.5, "seed": seed},
               {"p_fail": 0.9, "p_join": 0.1, "seed": seed},
               {"p_fail": 0.2, "seed": seed, "initial_live": 1}):
        js, ts = jM.RandomChurn(**kw), tM.RandomChurn(**kw)
        for r in range(10):
            np.testing.assert_array_equal(ts.live_mask(r, K),
                                          js.live_mask(r, K))
    for M in (jM, tM):
        assert M.get_churn(None).is_static and M.ScriptedChurn().is_static
        assert M.RandomChurn(p_fail=0.0).is_static
        assert set(M.CHURN_SCHEDULES) == {"none", "scripted", "random"}
        with pytest.raises(ValueError, match="zero live"):
            M.ScriptedChurn(events=(("crash", 0, 0),)).live_mask(0, 1)
        with pytest.raises(ValueError, match="unknown scripted-churn"):
            M.ScriptedChurn(events=(("boom", 0, 0),))
        with pytest.raises(KeyError, match="unknown churn"):
            M.get_churn("nope")


# --- the static reduction and the engines under churn ---------------------------
@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("codec", ["exact", "fused"])
def test_all_live_bit_identical_to_static(engine, codec):
    _, base = run(T, engine=engine, make=lambda p: {"codec": codec})
    for static in ("none", tM.NoChurn(), tM.ScriptedChurn()):
        learner, st = run(T, engine=engine,
                          make=lambda p, s=static: {"codec": codec,
                                                    "churn": s})
        assert not learner._churn_active
        for a, b in zip(leaves(base["params"]), leaves(st["params"])):
            assert torch.equal(a, b)
        assert st["membership"].live == (True,) * 4
        assert [x.live for x in st["log"]] == [4] * 4


CHURN = (("crash", 1, 1), ("rejoin", 3, 1), ("crash", 2, 3))
STRATEGIES = {
    "full-exact": lambda p: {},
    "full-fused": lambda p: {"codec": "fused"},
    "full-leafwise-ef": lambda p: {"codec": p.api.LeafwiseIntN(
        bits=4, error_feedback=True)},
    "full-fused-ef-weighted": lambda p: {
        "codec": p.api.FlatFusedIntN(bits=4, error_feedback=True),
        "aggregator": p.api.FullAverage(weights=(1.0, 2.0, 3.0, 4.0))},
    "partial": lambda p: {"aggregator": p.api.PartialParticipation(
        m=2, seed=1)},
}


@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_churn_rounds_match_jax(engine, name):
    """Crash, rejoin and a second crash (live 4, 3, 2, 3) through each
    live aggregate: losses, params, shared model, round state, bills and
    the membership log equal the JAX package's."""
    def make(p):
        return {**STRATEGIES[name](p),
                "churn": p.M.ScriptedChurn(events=CHURN)}
    _, js = run(J, engine=engine, make=make)
    _, ts = run(T, engine=engine, make=make)
    assert [x.live for x in ts["log"]] == [4, 3, 2, 3]
    assert_runs_match(js, ts)


def test_engines_agree_under_churn():
    def make(p):
        return {"codec": "leafwise", "churn": p.M.ScriptedChurn(
            events=CHURN)}
    _, sp = run(T, engine="python", make=make)
    _, sf = run(T, engine="fused", make=make)
    assert_runs_match(sp, sf)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_dead_slot_is_identity_carry(engine):
    """Slot 1 dies at round 1: its params AND momentum rows stay bit for
    bit at their end-of-round-0 values while the live slots train."""
    churn = tM.ScriptedChurn(events=(("crash", 1, 1),))
    learner, state = run(T, K=3, rounds=1, engine=engine,
                         optimizer="momentum",
                         make=lambda p: {"churn": churn}, T0=2)
    frozen_p = [t[1].clone() for t in leaves(state["params"])]
    frozen_o = [t[1].clone() for t in leaves(state["opt"])]
    data = T.conv(batches_np(3))
    for _ in range(2):
        state = learner.run_round(state, lambda i, j: data)
        assert all(torch.equal(a, t[1]) for a, t in
                   zip(frozen_p, leaves(state["params"])))
        assert all(torch.equal(a, t[1]) for a, t in
                   zip(frozen_o, leaves(state["opt"])))
    assert not torch.equal(frozen_p[1], leaves(state["params"])[1][0])


# --- the rejoin reference --------------------------------------------------------
@pytest.mark.parametrize("case", ["ring", "quiet"])
def test_rejoin_warm_starts_from_sync_ref(case):
    """Under the ring (rows differ; the dead slot 0 is stale) and after a
    quiet trigger round (slot 0 drifted) the restarted row is the sync
    reference, params and optimizer row, as in the JAX package."""
    out = []
    for pkg in (J, T):
        if case == "ring":
            learner, state = run(pkg, rounds=2, make=lambda p: {
                "aggregator": "ring",
                "churn": p.M.ScriptedChurn(events=(("crash", 1, 0),))})
        else:
            learner, state = run(pkg, K=3, rounds=1, T0=2, make=lambda p: {
                "sync_policy": p.api.DivergenceTrigger(delta=0.0)})
            learner.set_sync_policy(pkg.api.DivergenceTrigger(delta=1e9))
            data = pkg.conv(batches_np(3))
            state = learner.run_round(state, lambda i, j: data)
            assert not state["log"][-1].synced
        ref = np_tree(learner._sync_ref(state))
        row0 = [t[0] for t in np_tree(state["params"])]
        assert max(float(np.abs(a - b).max()) for a, b in zip(row0, ref)) > 0
        learner.restart_participant(state, 2)
        got = [t[2] for t in np_tree(state["params"])]
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        out.append(got)
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, **TOL)


# --- live matrices, bills and the divergence ------------------------------------
LIVES = [np.array(x, bool) for x in ([1, 0, 1, 0, 1], [0, 1, 1, 1, 1],
                                     [1, 0, 0, 0, 0], [1, 1, 1, 1, 1])]


def test_live_mixing_matrices_match_jax():
    """FullAverage (uniform and weighted) renormalised over the live set,
    partial participation drawing only live slots (m_eff = min(m,
    n_live)): equal to the JAX matrices bit for bit, with the same
    errors."""
    for make in (lambda p: p.FullAverage(),
                 lambda p: p.FullAverage(weights=(1.0, 2.0, 3.0, 4.0, 5.0)),
                 lambda p: p.PartialParticipation(m=3, seed=4),
                 lambda p: p.PartialParticipation(
                     m=2, weights=(0.0, 1.0, 2.0, 3.0, 4.0))):
        ja, ta = make(japi), make(tapi)
        for i, live in enumerate(LIVES):
            for r in range(3):
                try:
                    want = ja.mixing_matrix(r + i, 5, live=live)
                except ValueError as e:
                    with pytest.raises(ValueError, match=re.escape(
                            str(e)[:30])):
                        ta.mixing_matrix(r + i, 5, live=live)
                    continue
                got = ta.mixing_matrix(r + i, 5, live=live)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                assert np.allclose(got[:, ~live], 0.0)
    for ja, ta in ((japi.FullAverage(), tapi.FullAverage()),
                   (japi.PartialParticipation(), tapi.PartialParticipation())):
        for agg in (ja, ta):
            with pytest.raises(ValueError, match="live"):
                agg.mixing_matrix(0, 4, live=np.zeros(4, bool))


def test_live_bills_match_jax():
    stacked = {"w": np.zeros((5, 300), np.float32),
               "b": np.zeros((5, 7), np.float32)}
    js, ts = J.conv(stacked), T.conv(stacked)
    for make in (lambda p: p.FullAverage(), lambda p: p.RingGossip(),
                 lambda p: p.PartialParticipation(m=3),
                 lambda p: p.GraphGossip("complete"),
                 lambda p: p.D2Gossip("grid2d")):
        for codec in ("exact", "leafwise", "fused"):
            ja, ta = make(japi), make(tapi)
            jc, tc = japi.get_codec(codec), tapi.get_codec(codec)
            for live in LIVES + [None]:
                assert (ta.comm_bytes(tc, ts, 1, live=live)
                        == ja.comm_bytes(jc, js, 1, live=live))


def test_live_divergence_matches_jax():
    rng = np.random.default_rng(0)
    stacked = {"w": rng.normal(size=(3, 5, 4)).astype(np.float32),
               "b": rng.normal(size=(3, 2)).astype(np.float32)}
    stacked["w"][2] += 50.0
    ref = {"w": rng.normal(size=(5, 4)).astype(np.float32),
           "b": rng.normal(size=(2,)).astype(np.float32)}
    for live in ([True, True, False], [False, True, False], None):
        want = jsched.divergence(J.conv(stacked), J.conv(ref), live)
        got = tsched.divergence(T.conv(stacked), T.conv(ref), live)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    live_t = torch.tensor([1.0, 1.0, 1.0])
    assert float(tsched.divergence_tensor(T.conv(stacked), T.conv(ref),
                                          live_t)) == pytest.approx(
        tsched.divergence(T.conv(stacked), T.conv(ref)), rel=1e-6)


# --- the sync policies under membership events ----------------------------------
def test_policies_read_membership_events():
    """ILE holds its doubling on an event round; a join forces the
    divergence trigger's sync (threshold -1) in both engines, as in the
    JAX package; ``RoundLog.live`` counts the live slots."""
    for api in (japi, tapi):
        st = api.SyncState(T=2)
        assert api.ILE(epsilon=0.1).update(
            st, 0, 0.0, events=((0, 1, "leave"),)).T == 2
        assert api.ILE(epsilon=0.1).update(st, 0, 0.0).T == 4
        assert api.DivergenceTrigger(delta=0.5).round_delta(
            ((3, 1, "join"),)) == -1.0
    churn = (("crash", 1, 1), ("rejoin", 2, 1))
    for engine in ("python", "fused"):
        pats = []
        for pkg in (J, T):
            _, state = run(pkg, K=3, rounds=3, engine=engine,
                           make=lambda p: {
                               "churn": p.M.ScriptedChurn(events=churn),
                               "sync_policy": p.api.DivergenceTrigger(
                                   delta=1e9)})
            pats.append([(x.synced, x.live, x.comm_bytes > 0)
                         for x in state["log"]])
        assert pats[0] == pats[1] == [(False, 3, False), (True, 2, True),
                                      (True, 3, True)]
    # ILE at epsilon 1: rel inf at round 0, the event rounds 1 and 2
    # hold T, round 3 doubles it
    for engine in ("python", "fused"):
        Ts = [[h[2] for h in run(pkg, K=3, rounds=4, engine=engine,
                                 epsilon=1.0, make=lambda p: {
                                     "churn": p.M.ScriptedChurn(
                                         events=churn)})[1]["ctrl"].history]
              for pkg in (J, T)]
        assert Ts[0] == Ts[1] == [1, 1, 1, 2]


# --- standby slots and the naive ablation ---------------------------------------
def test_k_max_standby_slots_match_jax():
    """``ParticipantData(k_max=)`` cycles the real shards into standby
    slots as the JAX pipeline does, and a standby slot that joins at round
    1 trains with the others from then on, in both engines."""
    rng = np.random.default_rng(0)
    shards = [[rng.normal(size=(6 + 2 * k, 3)).astype(np.float32)]
              for k in range(2)]
    jd, td = JData(shards, 2, 0, k_max=5), TData(shards, 2, 0, k_max=5)
    assert td.K == jd.K == 5 and td.n_shards == jd.n_shards == 2
    for r, e in ((0, 0), (1, 1)):
        np.testing.assert_array_equal(td.epoch_batches(r, e)[0],
                                      jd.epoch_batches(r, e)[0])
    with pytest.raises(ValueError, match="k_max"):
        TData(shards, 2, k_max=1)
    for engine in ("python", "fused"):
        runs = [run(pkg, K=3, rounds=3, engine=engine, make=lambda p: {
            "churn": p.M.ScriptedChurn(events=(("rejoin", 1, 2),),
                                       initial_live=2)})[1]
                for pkg in (J, T)]
        assert runs[1]["membership"].events == ((1, 2, "join"),)
        assert [x.live for x in runs[1]["log"]] == [2, 3, 3]
        assert_runs_match(*runs)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_naive_membership_keeps_static_matrix(engine):
    """``liveness_aware=False``: the static uniform mean over all K
    (including the dead row's stale model) reaches the live rows, the dead
    row is still carried, and both equal the JAX package's."""
    def make(aware):
        return lambda p: {"churn": p.M.ScriptedChurn(events=(("crash", 1,
                                                               2),)),
                          "liveness_aware": aware, "codec": "fused"}
    learner, naive = run(T, K=3, rounds=1, engine=engine, make=make(False))
    dead = naive["params"]["w"][2].clone()
    data = T.conv(batches_np(3))
    naive = learner.run_round(naive, lambda i, j: data)
    assert learner.round_weights(1, naive) is None
    assert torch.equal(naive["params"]["w"][2], dead)     # carried
    _, aware = run(T, K=3, rounds=2, engine=engine, make=make(True))
    assert not torch.allclose(naive["params"]["w"][0],
                              aware["params"]["w"][0], atol=1e-6)
    assert_runs_match(run(J, K=3, rounds=2, engine=engine,
                          make=make(False))[1], naive)


# --- the train CLI ---------------------------------------------------------------
CLI = ["--participants", "3", "--rounds", "3", "--t0", "1", "--n-examples",
       "48", "--batch-size", "4", "--seq-len", "16", "--steps-per-epoch",
       "2", "--codec", "fused"]
LINE = re.compile(r"^round (\d+): T=(\d+) lr (\S+) rel_dw=\S+ "
                  r"local_loss=\S+ eval=\S+ (comm=\S+ next_T=\d+.*) \(")


def _fields(out):
    return [LINE.match(x).groups() for x in out.splitlines()
            if x.startswith("round ")]


def test_train_cli_churn_flags_print_the_jax_fields(capsys):
    """Scripted churn with a standby slot (``--k-max 4``), both engines:
    the data-independent fields (T, rates, bill, next T, ``live=n/K``)
    equal the JAX CLI's round for round, and the engines print the same
    lines; random churn with the naive ablation runs too."""
    flags = ["--churn", "scripted", "--churn-events",
             "crash:1:1,rejoin:2:3", "--k-max", "4"]
    outs = {}
    for engine in ("fused", "python"):
        assert ttrain.main(CLI + flags + ["--engine", engine,
                                          "--device", "cpu"]) == 0
        outs[engine] = capsys.readouterr().out
    assert jtrain.main(CLI + flags) == 0
    j_out = capsys.readouterr().out
    strip = [re.sub(r" \([\d.]+s\)$", "", x) for x in
             outs["fused"].splitlines()[1:]]
    assert strip == [re.sub(r" \([\d.]+s\)$", "", x)
                     for x in outs["python"].splitlines()[1:]]
    assert _fields(outs["fused"]) == _fields(j_out)
    assert [f[3].split()[-1] for f in _fields(j_out)] == [
        "live=3/4", "live=2/4", "live=3/4"]
    assert "churn=scripted k_max=4" in outs["fused"].splitlines()[0]
    assert ttrain.main(CLI + ["--churn", "random", "--churn-p", "0.5",
                              "--naive-membership", "--device", "cpu"]) == 0
    assert "naive" in capsys.readouterr().out


@pytest.mark.parametrize("argv, msg", [
    (["--churn-events", "crash:1:1"], "--churn scripted"),
    (["--churn-p", "0.5"], "--churn random"),
    (["--k-max", "8"], "--k-max requires --churn"),
    (["--churn", "random", "--k-max", "2", "--participants", "5"],
     "smaller than"),
    (["--churn", "scripted", "--churn-events", "crash:oops:1"],
     "kind:round:slot"),
    (["--naive-membership"], "requires --churn"),
])
def test_train_cli_rejects_churn_flags_as_jax(argv, msg, capsys):
    for main, extra in ((ttrain.main, ["--device", "cpu"]),
                        (jtrain.main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


def test_rel_when_the_first_live_slot_leaves_gossip():
    """Ring gossip, slot 0 (the shared model's row) crashes at round 1:
    both port engines measure Eq. 4 against the last shared model, as the
    JAX python engine does. (The JAX fused engine reads the new first
    live slot's entry row instead, a different model under gossip; see
    ROADMAP.md queue 3.)"""
    def make(p):
        return {"aggregator": "ring",
                "churn": p.M.ScriptedChurn(events=(("crash", 1, 0),))}
    _, jp = run(J, rounds=3, make=make)
    _, jf = run(J, rounds=3, engine="fused", make=make)
    for engine in ("python", "fused"):
        _, ts = run(T, rounds=3, engine=engine, make=make)
        assert_runs_match(jp, ts)
    assert abs(jf["log"][1].rel_change - jp["log"][1].rel_change) > 0.1
