"""The sync-policy API of the port against the JAX package, on the CPU:
``SyncState``'s history and skipped rounds, ``EpochController``, the
divergence metric, and ``DivergenceTrigger`` through both round engines
(single-shot and chunked fused rounds, with and without error feedback).

Shaped after ``tests/test_policies.py``: the tiny linear model with
JAX-drawn params and batches, the same numpy data on both sides, and the
smoke transformer for one gated run of the whole slice.

Tolerances: trajectories (losses, ``rel``, T, rates) within 1e-5, the
divergence within 1e-5 relative, sync patterns and comm bytes exact; a
quiet round keeps the local state bit for bit. Every run that compares
sync patterns first asserts that each round's divergence clears δ by more
than 5% of δ, so the pattern does not hang on the last digits of f32
arithmetic (a divergence near δ is why three of the JAX suite's own
trigger tests disagree between machines).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import engine as jengine
from repro.core import schedule as jsched
from repro.core.colearn import CoLearner as JCoLearner
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import schedule as tsched
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import leaves, tree_map

TOL = {"rtol": 1e-5, "atol": 1e-6}
MARGIN = 0.05


# --- the tiny model on both sides (tests/test_policies.py's) -----------------
def jloss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def tloss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def zero_jloss(params, batch):
    return jnp.zeros(()), {}


def zero_tloss(params, batch):
    return (params["w"].sum() + params["b"].sum()) * 0.0, {}


def params_np(key=0, d=4):
    w = jax.random.normal(jax.random.PRNGKey(key), (d, 1))
    return {"w": np.asarray(w), "b": np.zeros((1,), np.float32)}


def batches_np(K, n_batches, B, d=4, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (K, n_batches, B, d))
    return np.asarray(x), np.asarray(x @ jnp.arange(1.0, d + 1)[:, None])


def jengine_of(engine, chunk):
    return (japi.PythonEngine() if engine == "python"
            else japi.FusedEngine(chunk))


def tengine_of(engine, chunk):
    return (tapi.PythonEngine() if engine == "python"
            else tapi.FusedEngine(chunk))


def run_pair(cfg, rounds, b, *, engine="python", chunk=32, zero=False,
             optimizer="sgd", **strategies):
    """The same rounds through both packages' learners. ``strategies``
    maps a ``CoLearner`` keyword to ``make(api_module) -> object``."""
    out = []
    for mod, CL, loss, eng, conv in (
            (japi, JCoLearner, zero_jloss if zero else jloss,
             jengine_of(engine, chunk),
             lambda t: jax.tree.map(jnp.asarray, t)),
            (tapi, TCoLearner, zero_tloss if zero else tloss,
             tengine_of(engine, chunk),
             lambda t: params_from_numpy(t, "cpu"))):
        kw = {k: make(mod) for k, make in strategies.items()}
        if CL is TCoLearner:
            kw["device"] = "cpu"
        learner = CL(cfg, loss, optimizer_name=optimizer, round_engine=eng,
                     **kw)
        state = learner.init(conv(params_np()))
        data = conv(b)
        for _ in range(rounds):
            state = learner.run_round(state, lambda i, j: data)
        out.append((learner, state))
    return out


def recorded_divs(cfg, rounds, b, delta, **strategies):
    """Each round's divergence, from the JAX python engine's host gate."""
    divs = []

    @dataclasses.dataclass(frozen=True)
    class Recording(japi.DivergenceTrigger):
        def should_sync(self, div, round_i, delta=None):
            divs.append(div)
            return super().should_sync(div, round_i, delta)

    learner = JCoLearner(cfg, jloss, sync_policy=Recording(delta=delta,
                                                           epsilon=0.5),
                         **{k: m(japi) for k, m in strategies.items()})
    state = learner.init(jax.tree.map(jnp.asarray, params_np()))
    data = jax.tree.map(jnp.asarray, b)
    for _ in range(rounds):
        state = learner.run_round(state, lambda i, j: data)
    return divs


def assert_margin(divs, delta):
    worst = min(abs(d - delta) / abs(delta) for d in divs)
    assert worst > MARGIN, (divs, delta)


def logs_close(js, ts):
    jl, tl = js["log"], ts["log"]
    assert [x.synced for x in jl] == [x.synced for x in tl]
    assert [x.comm_bytes for x in jl] == [x.comm_bytes for x in tl]
    assert [x.T for x in jl] == [x.T for x in tl]
    for x, y in zip(jl, tl):
        np.testing.assert_allclose(y.local_losses, x.local_losses, **TOL)
        np.testing.assert_allclose([y.lr_first, y.lr_last],
                                   [x.lr_first, x.lr_last], **TOL)
        if np.isinf(x.rel_change):
            assert np.isinf(y.rel_change)
        else:
            np.testing.assert_allclose(y.rel_change, x.rel_change, **TOL)
    assert js["ctrl"].skipped == ts["ctrl"].skipped
    assert js["ctrl"].T == ts["ctrl"].T


def tree_diff(j, t):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jax.tree.leaves(j), leaves(t)))


# --- SyncState, EpochController, the divergence metric ------------------------
def test_sync_state_and_epoch_controller_match_jax():
    """ILE / FLE / DivergenceTrigger fold the same rounds into the same
    (round, rel, T) triples and skipped rounds; so does the legacy
    EpochController."""
    steps = [(0, 0.5, True), (1, 0.009, True), (2, 0.004, False),
             (3, 0.002, True)]
    for make in (lambda m: m.ILE(epsilon=0.01), lambda m: m.FLE(),
                 lambda m: m.DivergenceTrigger(delta=0.1, epsilon=0.01)):
        states = []
        for mod in (japi, tapi):
            pol = make(mod)
            st = pol.init_state(5)
            for i, rel, synced in steps:
                st = pol.update(st, i, rel, synced)
            states.append(st)
        assert (states[1].T, states[1].history, states[1].skipped) == (
            states[0].T, states[0].history, states[0].skipped)
    assert states[1].skipped == (2,)
    assert states[1].history[-1] == (3, 0.002, 20)
    ctrls = []
    for cls in (jsched.EpochController, tsched.EpochController):
        c = cls(T=5, epsilon=0.01, rule="ile")
        for rel in (0.5, 0.009, 0.2):
            c = c.update(rel)
        ctrls.append(c)
    assert ctrls[0].history == ctrls[1].history == (
        (0, 0.5, 5), (1, 0.009, 10), (2, 0.2, 10))
    assert tsched.EpochController(T=3, epsilon=1.0, rule="fle").update(
        0.0).T == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_divergence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    stacked = {"w": rng.standard_normal((3, 7, 5)).astype(np.float32),
               "v": rng.standard_normal((3, 300)).astype(np.float32)}
    ref = {"w": rng.standard_normal((7, 5)).astype(np.float32),
           "v": rng.standard_normal(300).astype(np.float32)}
    want = jsched.divergence(jax.tree.map(jnp.asarray, stacked),
                             jax.tree.map(jnp.asarray, ref))
    got = tsched.divergence(params_from_numpy(stacked, "cpu"),
                            params_from_numpy(ref, "cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    t = tsched.divergence_tensor(params_from_numpy(stacked, "cpu"),
                                 params_from_numpy(ref, "cpu"))
    assert t.dtype == torch.float32 and t.ndim == 0
    # the manual case of the JAX suite
    man = tsched.divergence({"w": torch.tensor([[3.0, 0.0], [0.0, 4.0]])},
                            {"w": torch.tensor([1.0, 1.0])})
    np.testing.assert_allclose(
        man, np.sqrt(((2 ** 2 + 1) + (1 + 3 ** 2)) / 2) / np.sqrt(2),
        rtol=1e-6)


# --- DivergenceTrigger through the engines --------------------------------------
DELTA = 0.3   # every divergence of this run is >= 13% away from it


@pytest.mark.parametrize("codec", ["exact", "fused-int4-ef"])
@pytest.mark.parametrize("engine,chunk", [("python", 32), ("fused", 32),
                                          ("fused", 1)])
def test_divergence_trigger_matches_jax(engine, chunk, codec):
    """Six rounds of T0 = 2 with the trigger's optional doubling: synced,
    quiet and synced-again rounds, the same pattern, bills, skipped rounds
    and trajectories as the JAX package (chunk = 1: the gate after two
    chunk graphs)."""
    cfg = CoLearnConfig(n_participants=3, T0=2, eta0=0.05, epsilon=0.5,
                        max_rounds=6)
    b = batches_np(3, 4, 8)

    def mk_codec(m):
        return (m.ExactF32() if codec == "exact"
                else m.get_codec("fused", bits=4, error_feedback=True))
    assert_margin(recorded_divs(cfg, 6, b, DELTA, codec=mk_codec), DELTA)
    (jl, js), (tl, ts) = run_pair(
        cfg, 6, b, engine=engine, chunk=chunk, codec=mk_codec,
        sync_policy=lambda m: m.DivergenceTrigger(delta=DELTA, epsilon=0.5))
    logs_close(js, ts)
    assert [x.synced for x in ts["log"]] == [True, True, False, True,
                                             False, False]
    assert ts["ctrl"].skipped == (2, 4, 5)
    up = tl.codec.wire_bytes(ts["params"])
    assert {x.comm_bytes for x in ts["log"]} == {0, up + tl.param_bytes(ts)}
    assert tree_diff(js["params"], ts["params"]) <= 1e-5
    assert tree_diff(js["prev_avg"], ts["prev_avg"]) <= 1e-5
    if codec != "exact":
        assert float(np.abs(np.asarray(js["residual"])
                            - ts["residual"].numpy()).max()) <= 1e-5
    if engine == "fused":
        r = tl._runner
        assert r._gate.captures == 1 and r._round.captures == 0
        assert r._finalize.captures == 1


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_quiet_rounds_bill_nothing(engine):
    """Zero gradients: the locals never drift, every round is quiet (even
    round 0), bills zero bytes and reports the divergence (0) as rel."""
    cfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.01, max_rounds=4)
    (_, js), (_, ts) = run_pair(
        cfg, 4, batches_np(2, 1, 2), engine=engine, zero=True,
        sync_policy=lambda m: m.DivergenceTrigger(delta=0.05))
    logs_close(js, ts)
    assert [x.synced for x in ts["log"]] == [False] * 4
    assert [x.comm_bytes for x in ts["log"]] == [0] * 4
    assert [x.rel_change for x in ts["log"]] == [0.0] * 4
    assert ts["ctrl"].skipped == (0, 1, 2, 3)


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_quiet_round_preserves_local_state(engine):
    """A synced round under int4 error feedback (δ = -1 forces it), then a
    quiet one (δ swapped to 1e9, no rebind): params and momentum equal
    one local epoch run by hand from the round's entry state, bit for
    bit; the residual and the sync reference are untouched."""
    cfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.05, max_rounds=4)
    b = tuple(map(torch.as_tensor, batches_np(2, 2, 4)))
    learner = TCoLearner(cfg, tloss, optimizer_name="momentum",
                         codec=tapi.get_codec("fused", bits=4,
                                              error_feedback=True),
                         round_engine=tengine_of(engine, 32),
                         sync_policy=tapi.DivergenceTrigger(delta=-1.0),
                         device="cpu")
    state = learner.init(params_from_numpy(params_np(), "cpu"))
    state = learner.run_round(state, lambda i, j: b)
    runner = learner._runner
    learner.set_sync_policy(tapi.DivergenceTrigger(delta=1e9))
    assert learner._runner is runner
    entry = {k: tree_map(torch.clone, state[k])
             for k in ("params", "opt", "residual", "prev_avg")}
    assert float(entry["residual"].abs().max()) > 0
    state = learner.run_round(state, lambda i, j: b)
    log = state["log"][-1]
    assert not log.synced and log.comm_bytes == 0
    p, o, _ = learner._epoch(entry["params"], entry["opt"], b, log.lr_first)
    for got, want in ((state["params"], p), (state["opt"], o),
                      (state["residual"], entry["residual"]),
                      (state["prev_avg"], entry["prev_avg"])):
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves(got), leaves(want)))


def test_custom_gated_policy_is_honoured_by_both_engines():
    """An inverted gate (sync only while quiet) with the legacy
    two-argument ``should_sync``: both engines sync every round under zero
    gradients, where the default gate would skip every one. Assigning a
    policy with another traced gate directly raises; ``set_sync_policy``
    rebinds."""
    def inverted(mod):
        @dataclasses.dataclass(frozen=True)
        class SyncWhileQuiet(mod.DivergenceTrigger):
            name = "quietsync"

            def should_sync(self, div, round_i):
                return div <= self.delta

            def traced_should_sync(self, div, delta):
                return div <= delta
        return SyncWhileQuiet(delta=0.5)

    assert not tapi._gate_accepts_delta(inverted(tapi))
    assert tapi._gate_accepts_delta(tapi.DivergenceTrigger())
    cfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.01, max_rounds=3)
    b = batches_np(2, 1, 2)
    for engine in ("python", "fused"):
        (_, js), (tl, ts) = run_pair(cfg, 3, b, engine=engine, zero=True,
                                     sync_policy=inverted)
        logs_close(js, ts)
        assert [x.synced for x in ts["log"]] == [True] * 3
    data = tuple(map(torch.as_tensor, b))
    tl.sync_policy = tapi.DivergenceTrigger(delta=0.5)
    with pytest.raises(RuntimeError, match="set_sync_policy"):
        tl.run_round(ts, lambda i, j: data)
    tl.set_sync_policy(tapi.DivergenceTrigger(delta=0.5))
    ts = tl.run_round(ts, lambda i, j: data)
    assert not ts["log"][-1].synced


def test_set_sync_policy_rebinds_only_when_the_gate_changes():
    """ILE -> trigger rebinds the fused engine (a direct assignment
    raises); another δ rides the static buffer (no rebind, no capture);
    trigger -> ILE rebinds again."""
    cfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.01, max_rounds=6)
    b = tuple(map(torch.as_tensor, batches_np(2, 2, 4)))
    learner = TCoLearner(cfg, tloss, round_engine="fused", device="cpu")
    state = learner.init(params_from_numpy(params_np(), "cpu"))
    state = learner.run_round(state, lambda i, j: b)
    assert state["log"][-1].synced
    learner.sync_policy = tapi.DivergenceTrigger(delta=1e9)
    with pytest.raises(RuntimeError, match="set_sync_policy"):
        learner.run_round(state, lambda i, j: b)
    ungated = learner._runner
    learner.set_sync_policy(tapi.DivergenceTrigger(delta=1e9))
    gated = learner._runner
    assert gated is not ungated
    state = learner.run_round(state, lambda i, j: b)
    assert not state["log"][-1].synced and state["log"][-1].comm_bytes == 0
    learner.set_sync_policy("divtrigger")             # δ 0.05: no rebind
    assert learner._runner is gated
    state = learner.run_round(state, lambda i, j: b)
    assert (gated._gate.captures, gated._gate.replays) == (1, 0)
    learner.set_sync_policy("ile")
    assert learner._runner is not gated
    state = learner.run_round(state, lambda i, j: b)
    assert state["log"][-1].synced


def test_registry_resolves_the_trigger():
    pol = tapi.get_sync_policy("divtrigger", delta=0.2)
    assert isinstance(pol, tapi.DivergenceTrigger) and pol.delta == 0.2
    assert pol.epsilon is None                   # cfg's ε does not leak in
    cfg = CoLearnConfig(epsilon=0.3)
    assert tapi.get_sync_policy("divergence", cfg).epsilon is None
    assert tapi.get_sync_policy("divtrigger", cfg, epsilon=0.4).epsilon == 0.4
    assert pol.round_delta() == 0.2 and pol.round_delta(("join",)) == -1.0
    assert not tapi.ILE().divergence_gated and pol.divergence_gated


# --- the gated fused functions, single shot --------------------------------------
@pytest.mark.parametrize("delta", [1e-3, 1e9])
@pytest.mark.parametrize("stateful", [False, True])
def test_gated_round_and_finalize_match_jax(stateful, delta):
    """``make_fused_round(gated=True)`` (two epochs, the gate and the
    synced or quiet finalize in one call, from equal rows),
    ``make_fused_finalize(gated=True)`` (on rows that differ) and the
    pieces the fused runner replays on those rows (``make_fused_gate``,
    then the plain finalize only on a synced round) against the JAX
    package's gated functions, on a synced (δ 1e-3) and a quiet (δ 1e9)
    round."""
    from repro.optim.optimizers import get_optimizer as jget_optimizer
    K = 2
    b = batches_np(K, 2, 4)
    batches = tuple(np.stack([x, x]) for x in b)          # T_i = 2
    p = params_np()
    stacked = {k: np.stack([v] * K) for k, v in p.items()}
    rows = {k: v + np.arange(K, dtype=np.float32).reshape(
        (K,) + (1,) * (v.ndim - 1)) * 0.1 for k, v in stacked.items()}
    sched = np.array([0.05, 0.25, 0.0, 0.0], np.float32)
    codec = ("fused", {"bits": 4, "error_feedback": True} if stateful
             else {"bits": 8})
    synced = delta < 1

    def run(mod, eng, opt, conv, init_opt, scalar, f32, loss, **kw):
        c = mod.get_codec(codec[0], **codec[1])
        agg = mod.FullAverage().make_aggregate_fn(c)
        rnd = eng.make_fused_round(loss, opt, aggregate_fn=agg, gated=True,
                                   stateful=stateful, **kw)
        fin = eng.make_fused_finalize(opt, aggregate_fn=agg, gated=True,
                                      stateful=stateful, **kw)
        out = []
        for tree, call in ((stacked, "round"), (rows, "finalize")):
            sp = conv(tree)
            lead = (sp, init_opt(opt, sp)) + (
                (c.init_state(sp),) if stateful else ())
            if call == "round":
                res = rnd(*lead, conv(batches), scalar(0),
                          {"kind": scalar(0), "p": conv(sched)}, scalar(4),
                          conv(p), f32(delta), None)
                aux = res[2]
                out.append((res[0], res[1], aux["rel"], aux["div"],
                            aux["synced"], aux["new_avg"], aux["losses"],
                            aux["lrs"]))
            else:
                before = jax.tree.map(np.array, (lead[0], lead[1]))
                out.append(fin(*lead, conv(p), f32(delta), None)
                           + (before,))
        if mod is tapi:
            # the runner's split: the gate, then the plain finalize only
            # when the device decided to sync
            sp = conv(rows)
            lead = (sp, init_opt(opt, sp)) + (
                (c.init_state(sp),) if stateful else ())
            ref = conv(p)
            div, do_sync = eng.make_fused_gate()(sp, ref, f32(delta))
            rel = div
            if bool(do_sync):
                rel = eng.make_fused_finalize(
                    opt, aggregate_fn=agg, stateful=stateful)(
                        *lead, ref, None)[2]
            out.append((lead[0], lead[1], rel, div, do_sync, ref))
        return out

    jr, jf = run(japi, jengine, jget_optimizer("momentum"),
                 lambda t: jax.tree.map(jnp.asarray, t),
                 lambda o, sp: jax.vmap(o.init)(sp), jnp.int32, jnp.float32,
                 jloss, donate=False)
    tr, tf, ts = run(tapi, tengine, get_optimizer("momentum"),
                     lambda t: params_from_numpy(t, "cpu"),
                     tengine.init_stacked_opt,
                     lambda v: torch.tensor(v, dtype=torch.int32),
                     lambda v: torch.tensor(v, dtype=torch.float32), tloss)
    for j, t in ((jr, tr), (jf, tf), (jf, ts)):
        assert bool(t[4]) == bool(j[4]) == synced
        np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-5)
        if synced:
            np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-5)
        else:
            assert float(t[2]) == float(t[3])
        for k in (0, 1, 5):                      # params, opt, new_ref
            assert tree_diff(j[k], t[k]) <= 1e-5
    np.testing.assert_allclose(tr[6].numpy(), np.asarray(jr[6]), **TOL)
    np.testing.assert_allclose(tr[7].numpy(), np.asarray(jr[7]), rtol=1e-6)
    if not synced:
        # the quiet finalize is an identity carry of what it was given
        before = tf[-1]
        assert all(np.array_equal(x.numpy(), y) for x, y in zip(
            leaves((tf[0], tf[1])), jax.tree.leaves(before)))


# --- the whole slice: the smoke transformer --------------------------------------
def test_gated_smoke_transformer_matches_jax():
    """Four gated rounds of the 1-layer smoke transformer, K = 3, over the
    fused int8 codec (quiet, synced, quiet, synced): the port's fused and
    python engines against the JAX fused engine."""
    from repro.configs import get_smoke_config
    from repro.data.partition import partition_arrays
    from repro.data.pipeline import ParticipantData
    from repro.data.synthetic import lm_examples
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    cfg = get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, segments=((("gqa:dense",), 1),))
    K, rounds, delta = 3, 4, 0.0095
    x, y = lm_examples(0, 24, 16, cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K, 0), batch_size=4)
    p_np = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0),
                                                    cfg, jnp.float32))
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05,
                         max_rounds=rounds)
    divs = []

    @dataclasses.dataclass(frozen=True)
    class Recording(japi.DivergenceTrigger):
        def should_sync(self, div, round_i, delta=None):
            divs.append(div)
            return super().should_sync(div, round_i, delta)

    def jrun(policy, engine):
        learner = JCoLearner(
            ccfg, lambda p, b: jtr.loss_fn(
                p, cfg, {"tokens": b[0], "labels": b[1]}),
            codec=japi.get_codec("fused"), round_engine=engine,
            sync_policy=policy)
        state = learner.init(jax.tree.map(jnp.asarray, p_np))
        for _ in range(rounds):
            state = learner.run_round(state, lambda i, j: tuple(
                map(np.asarray, data.epoch_batches(i, j))))
        return state

    jrun(Recording(delta=delta), "python")
    assert_margin(divs, delta)
    js = jrun(japi.DivergenceTrigger(delta=delta), "fused")
    for engine in ("fused", "python"):
        learner = TCoLearner(
            ccfg, lambda p, b: ttr.loss_fn(
                p, cfg, {"tokens": b[0], "labels": b[1]}),
            codec=tapi.get_codec("fused"), round_engine=engine,
            sync_policy=tapi.DivergenceTrigger(delta=delta), device="cpu")
        ts = learner.init(params_from_numpy(p_np, "cpu"))
        for _ in range(rounds):
            ts = learner.run_round(ts, lambda i, j: tuple(
                map(torch.as_tensor, data.epoch_batches(i, j))))
        logs_close(js, ts)
        assert [x.synced for x in ts["log"]] == [False, True, False, True]
