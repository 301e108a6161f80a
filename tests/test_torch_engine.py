"""The fused round engine of the port (``repro_torch/core/engine.py``,
``api.FusedEngine``, ``core/graphs.py``) against its python engine and
against the JAX package's fused engine, on the CPU.

Shaped after ``tests/test_engine.py``: a tiny linear model with JAX-drawn
params and batches for the engine semantics (schedules x sync policies,
optimizers, codecs, chunking, the capture counts), and the smoke
transformer (1 layer, JAX-initialised params through
``params_from_numpy``) for the round trajectories against the JAX fused
engine. On the CPU nothing is captured: the graphs' ``captures`` count the
keys first run, which is what the card captures.

Tolerances: the device schedule against JAX's ``switch_lr`` at rtol 1e-6;
port fused against port python at 1e-5 (the fused rate is f32, the python
engine's a host double); port fused against JAX fused at 1e-5 for the logs
and, for the exact codec, the params; for the quantizing codecs the params
within one wire quantum, as ``tests/test_torch_colearn.py`` holds them.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core import engine as jengine
from repro.core import flatbuf as jfb
from repro.core import schedule as jsched
from repro.core.colearn import CoLearner as JCoLearner
from repro.data.partition import partition_arrays
from repro.data.pipeline import ParticipantData
from repro.data.synthetic import lm_examples
from repro.kernels import ref as jref
from repro.models import transformer as jtr
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import schedule as tsched
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves, tree_map

TOL = {"rtol": 1e-5, "atol": 1e-6}


# --- the tiny model (tests/test_engine.py's) ---------------------------------
def tiny_loss(params, batch):
    x, y = batch
    loss = torch.mean((x @ params["w"] + params["b"] - y) ** 2)
    return loss, {"loss": loss}


def tiny_params(key=0, d=4):
    w = jax.random.normal(jax.random.PRNGKey(key), (d, 1))
    return params_from_numpy({"w": np.asarray(w),
                              "b": np.zeros((1,), np.float32)}, "cpu")


def tiny_batches(K, n_batches, B, d=4, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (K, n_batches, B, d))
    y = x @ jnp.arange(1.0, d + 1)[:, None]
    return torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))


def run(cfg, engine, rounds, batches, *, chunk=32, params=None, **kw):
    learner = TCoLearner(
        cfg, tiny_loss, device="cpu",
        round_engine=(tapi.FusedEngine(chunk) if engine == "fused"
                      else engine), **kw)
    state = learner.init(params if params is not None else tiny_params())
    for _ in range(rounds):
        state = learner.run_round(state, lambda i, j: batches)
    return learner, state


def max_diff(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def logs_close(a, b, lr_rtol=1e-5):
    assert [x.T for x in a["log"]] == [x.T for x in b["log"]]
    for x, y in zip(a["log"], b["log"]):
        assert x.comm_bytes == y.comm_bytes
        np.testing.assert_allclose(y.local_losses, x.local_losses, **TOL)
        np.testing.assert_allclose([y.lr_first, y.lr_last],
                                   [x.lr_first, x.lr_last], rtol=lr_rtol,
                                   atol=1e-9)
        if np.isinf(x.rel_change):
            assert np.isinf(y.rel_change)
        else:
            np.testing.assert_allclose(y.rel_change, x.rel_change, **TOL)
    assert a["ctrl"].T == b["ctrl"].T
    assert a["global_epoch"] == b["global_epoch"]


# --- the device schedule -----------------------------------------------------
GRID = list(itertools.product([0, 1, 3, 7], [1, 2, 5, 8], [0, 4, 11],
                              [0, 1, 12, 40]))


@pytest.mark.parametrize("kind", [tsched.LR_EXP_ROUND, tsched.LR_EXP_GLOBAL,
                                  tsched.LR_COS_ROUND])
def test_switch_lr_matches_jax(kind):
    assert (tsched.LR_EXP_ROUND, tsched.LR_EXP_GLOBAL, tsched.LR_COS_ROUND,
            tsched.N_SCHED_PARAMS) == (jsched.LR_EXP_ROUND,
                                       jsched.LR_EXP_GLOBAL,
                                       jsched.LR_COS_ROUND,
                                       jsched.N_SCHED_PARAMS)
    p = np.array([0.05, 0.25, 0.001, 0.0], np.float32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    tsp = {"kind": i32(kind), "p": torch.tensor(p)}
    jsp = {"kind": jnp.int32(kind), "p": jnp.asarray(p)}
    got = [float(tsched.switch_lr(tsp, i32(j), i32(T), i32(ge), i32(tot)))
           for j, T, ge, tot in GRID]
    jswitch = jax.jit(jsched.switch_lr)
    want = [float(jswitch(jsp, jnp.int32(j), jnp.int32(T), jnp.int32(ge),
                          jnp.int32(tot)))
            for j, T, ge, tot in GRID]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    out = tsched.switch_lr(tsp, i32(1), i32(2), i32(3), i32(4))
    assert out.dtype == torch.float32 and out.ndim == 0


def test_switch_lr_clamps_the_branch_index_like_lax_switch():
    p = torch.tensor([0.05, 0.25, 0.001, 0.0])
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    args = (i32(1), i32(4), i32(3), i32(10))
    lo = tsched.switch_lr({"kind": i32(-3), "p": p}, *args)
    hi = tsched.switch_lr({"kind": i32(9), "p": p}, *args)
    assert float(lo) == float(tsched.switch_lr({"kind": i32(0), "p": p},
                                               *args))
    assert float(hi) == float(tsched.switch_lr({"kind": i32(2), "p": p},
                                               *args))


SCHEDULES = [
    (lambda m: m.CLR(0.03, 0.5)), (lambda m: m.ELR(0.02, 0.25)),
    (lambda m: m.WarmupCLR(0.04, 0.25, warmup_rounds=4)),
    (lambda m: m.CosineCyclical(0.05, 0.001))]


@pytest.mark.parametrize("make", SCHEDULES)
def test_device_round_params_match_jax(make):
    ts, js = make(tapi), make(japi)
    assert ts.name == js.name
    for i in range(6):
        assert ts.round_params(i) == js.round_params(i)
        tp = ts.device_round_params(i, device="cpu")
        jp = js.device_round_params(i)
        assert tp["kind"].dtype == torch.int32 and tp["kind"].ndim == 0
        assert int(tp["kind"]) == int(jp["kind"])
        np.testing.assert_array_equal(tp["p"].numpy(), np.asarray(jp["p"]))
        for j, T, ge, tot in ((0, 4, 3, 20), (3, 4, 9, 20)):
            # host forms: python doubles here, f32 jnp for JAX's cosine
            np.testing.assert_allclose(ts.lr(i, j, T, ge, tot),
                                       js.lr(i, j, T, ge, tot), rtol=1e-6)


@pytest.mark.parametrize("name", ["warmup_clr", "warmup", "cosine"])
def test_registry_resolves_the_new_schedules(name):
    cfg = CoLearnConfig(eta0=0.07)
    ts, js = tapi.get_schedule(name, cfg), japi.get_schedule(name, cfg)
    assert type(ts).__name__ == type(js).__name__
    assert ts.round_params(0) == js.round_params(0)


# --- port fused == port python ------------------------------------------------
@pytest.mark.parametrize("schedule", ["clr", "elr", "warmup_clr", "cosine"])
@pytest.mark.parametrize("rule", ["ile", "fle"])
def test_fused_matches_python_all_schedules(schedule, rule):
    cfg = CoLearnConfig(n_participants=3, T0=2, eta0=0.05, epsilon=0.5,
                        schedule="clr", epochs_rule=rule, max_rounds=3)
    b = tiny_batches(3, 4, 8)
    (_, sp), (fl, sf) = (run(cfg, e, 3, b, schedule=schedule)
                         for e in ("python", "fused"))
    logs_close(sp, sf)
    assert max_diff(sp["params"], sf["params"]) <= 1e-5
    assert max_diff(sp["prev_avg"], sf["prev_avg"]) <= 1e-5
    assert fl._fused_round.captures == len({x.T for x in sf["log"]})


@pytest.mark.parametrize("optimizer", ["momentum", "adamw"])
def test_fused_matches_python_stateful_optimizers(optimizer):
    cfg = CoLearnConfig(n_participants=2, T0=3, eta0=0.01, epsilon=0.5,
                        max_rounds=2)
    b = tiny_batches(2, 3, 8)
    (_, sp), (_, sf) = (run(cfg, e, 2, b, optimizer_name=optimizer)
                        for e in ("python", "fused"))
    logs_close(sp, sf)
    assert max_diff(sp["params"], sf["params"]) <= 1e-5
    # the optimizer state is reset in place at the finalize, as the
    # python engine's fresh state
    assert max_diff(sp["opt"], sf["opt"]) == 0.0


@pytest.mark.parametrize("codec", [
    ("leafwise", {}), ("fused", {}), ("fused", {"bits": 4,
                                                "error_feedback": True}),
    ("leafwise", {"bits": 4, "error_feedback": True})])
def test_fused_matches_python_with_codecs(codec):
    cfg = CoLearnConfig(n_participants=3, T0=2, eta0=0.05, epsilon=0.5,
                        max_rounds=3)
    b = tiny_batches(3, 2, 8, d=256)
    params = tiny_params(d=256)
    (_, sp), (fl, sf) = (
        run(cfg, e, 3, b, params=params,
            codec=tapi.get_codec(codec[0], **codec[1]))
        for e in ("python", "fused"))
    logs_close(sp, sf)
    assert max_diff(sp["params"], sf["params"]) <= 1e-5
    if codec[1].get("error_feedback"):
        assert max_diff(sp["residual"], sf["residual"]) <= 1e-5
    assert fl._fused_round.captures == len({x.T for x in sf["log"]})


def test_fused_matches_python_weighted_average():
    cfg = CoLearnConfig(n_participants=3, T0=1, eta0=0.05, max_rounds=2)
    b = tiny_batches(3, 2, 8, d=256)
    params = tiny_params(d=256)
    outs = [run(cfg, e, 2, b, params=params,
                codec=tapi.get_codec("fused"),
                aggregator=tapi.FullAverage(weights=(3, 1, 2)))
            for e in ("python", "fused")]
    logs_close(outs[0][1], outs[1][1])
    assert max_diff(outs[0][1]["params"], outs[1][1]["params"]) <= 1e-5
    # the mixing matrix sits in one static buffer across rounds
    learner = outs[1][0]
    assert learner.round_weights(0) is learner.round_weights(5)


def test_restart_participant_between_fused_rounds():
    """``restart_participant`` writes the row in place, so the fused
    engine's next round runs on the same storage (no new key) and equals
    the python engine after the same restart."""
    cfg = CoLearnConfig(n_participants=3, T0=1, eta0=0.05,
                        epochs_rule="fle", max_rounds=3)
    b = tiny_batches(3, 2, 8, d=256)
    params = tiny_params(d=256)
    codec = tapi.get_codec("fused", bits=4, error_feedback=True)
    out = {}
    for engine in ("python", "fused"):
        learner, state = run(cfg, engine, 2, b, params=params, codec=codec)
        with torch.no_grad():
            for t in leaves(state["params"]):
                t[1].add_(1.0)
        learner.restart_participant(state, 1)
        assert (state["residual"][1] == 0).all()
        out[engine] = (learner, learner.run_round(state, lambda i, j: b))
    (_, sp), (fl, sf) = out["python"], out["fused"]
    logs_close(sp, sf)
    assert max_diff(sp["params"], sf["params"]) <= 1e-5
    assert fl._fused_round.captures == 1


# --- chunking ------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [2, 5])
def test_fused_chunked_matches_python_and_single_shot(chunk):
    """T0 = 5 > chunk chains chunk functions and a finalize (remainder and
    no-remainder splits); the trajectory equals the python loop and the
    single-shot round."""
    cfg = CoLearnConfig(n_participants=2, T0=5, eta0=0.05, epsilon=0.5,
                        schedule="clr", epochs_rule="fle", max_rounds=2)
    b = tiny_batches(2, 3, 8)
    _, sp = run(cfg, "python", 2, b)
    _, single = run(cfg, "fused", 2, b)
    learner, chunked = run(cfg, "fused", 2, b, chunk=chunk)
    for other in (single, chunked):
        logs_close(sp, other)
        assert max_diff(sp["params"], other["params"]) <= 1e-5
    assert max_diff(single["params"], chunked["params"]) == 0.0
    assert learner._fused_round.captures == (1 if chunk == 5 else 0)
    assert learner._fused_epochs.captures == (0 if chunk == 5 else 2)


def test_fused_chunk_graph_reused_across_T_doubling():
    """T 2, 2, 4, 8 with chunk=2 under ILE: one round key, one chunk key,
    one finalize key; the budget (ELR's denominator) moves every round."""
    def zero_loss(params, batch):
        return (params["w"].sum() + params["b"].sum()) * 0, {}
    cfg = CoLearnConfig(n_participants=2, T0=2, epsilon=0.01,
                        epochs_rule="ile", schedule="elr", max_rounds=4)
    b = tiny_batches(2, 1, 2)
    learner = TCoLearner(cfg, zero_loss, device="cpu",
                         round_engine=tapi.FusedEngine(chunk=2))
    state = learner.init(tiny_params())
    for _ in range(4):
        state = learner.run_round(state, lambda i, j: b)
    assert [x.T for x in state["log"]] == [2, 2, 4, 8]
    assert (learner._fused_round.captures, learner._fused_epochs.captures,
            learner._fused_finalize.captures) == (1, 1, 1)
    assert learner._runner.graphs.captures == 3


def test_ile_doubling_identical_under_the_device_schedule():
    """Zero gradients -> rel = 0 -> Eq. 4 doubles T the same in both."""
    def zero_loss(params, batch):
        return (params["w"].sum() + params["b"].sum()) * 0, {}
    cfg = CoLearnConfig(n_participants=2, T0=1, epsilon=0.01,
                        epochs_rule="ile", max_rounds=3)
    b = tiny_batches(2, 1, 2)
    for engine in ("python", "fused"):
        learner = TCoLearner(cfg, zero_loss, device="cpu",
                             round_engine=engine)
        state = learner.init(tiny_params())
        for _ in range(3):
            state = learner.run_round(state, lambda i, j: b)
        assert [x.T for x in state["log"]] == [1, 1, 2], engine
        assert state["ctrl"].T == 4, engine


def test_clr_restarts_in_the_fused_round():
    cfg = CoLearnConfig(n_participants=2, T0=4, eta0=0.02, epsilon=0.0,
                        schedule="clr", epochs_rule="fle", max_rounds=3)
    _, state = run(cfg, "fused", 3, tiny_batches(2, 2, 8))
    for log in state["log"]:
        np.testing.assert_allclose(log.lr_first, 0.02, rtol=1e-6)
        np.testing.assert_allclose(
            log.lr_last, tsched.clr_lr(0.02, cfg.decay_rate, 3, 4),
            rtol=1e-6)


# --- schedule swaps --------------------------------------------------------------
def test_set_schedule_hot_swaps_without_a_new_capture():
    cfg = CoLearnConfig(n_participants=2, T0=2, eta0=0.02, epsilon=0.0,
                        epochs_rule="fle", max_rounds=6)
    b = tiny_batches(2, 2, 4)
    learner, state = run(cfg, "fused", 1, b)
    runner = learner._runner
    learner.set_schedule("cosine")
    state = learner.run_round(state, lambda i, j: b)
    learner.set_schedule(tapi.ELR(eta0=0.02))
    state = learner.run_round(state, lambda i, j: b)
    learner.set_schedule(tapi.WarmupCLR(eta0=0.02, warmup_rounds=8))
    state = learner.run_round(state, lambda i, j: b)
    assert learner._runner is runner
    assert learner._fused_round.captures == 1
    lrs = [(x.lr_first, x.lr_last) for x in state["log"]]
    np.testing.assert_allclose(lrs[0][0], 0.02, rtol=1e-6)
    np.testing.assert_allclose(lrs[1][1], 0.01, rtol=1e-5)   # cos @ T/2
    assert lrs[2][0] < 0.02                                  # elr mid-anneal
    np.testing.assert_allclose(lrs[3][0], 0.02 * 4 / 8, rtol=1e-6)


def _clone_state(state):
    out = dict(state)
    for k in ("params", "opt", "residual", "prev_avg"):
        out[k] = tree_map(torch.clone, state[k])
    out["log"] = list(state["log"])
    return out


@pytest.mark.parametrize("new", ["elr", "cosine", "warmup_clr"])
def test_set_schedule_swap_equals_a_learner_built_with_it(new):
    """After a swap, the next round equals that round run by a learner
    built with the new schedule from the same state."""
    cfg = CoLearnConfig(n_participants=3, T0=3, eta0=0.05, epsilon=0.0,
                        epochs_rule="fle", max_rounds=4)
    b = tiny_batches(3, 2, 8)
    swapped, state = run(cfg, "fused", 1, b)
    other = TCoLearner(cfg, tiny_loss, device="cpu", round_engine="fused",
                       schedule=new)
    ostate = _clone_state(state)
    swapped.set_schedule(new)
    state = swapped.run_round(state, lambda i, j: b)
    ostate = other.run_round(ostate, lambda i, j: b)
    logs_close(ostate, state, lr_rtol=0)
    assert max_diff(ostate["params"], state["params"]) == 0.0


def test_custom_traced_lr_needs_set_schedule():
    class Flat(tapi.CLR):
        traced_lr = staticmethod(lambda sp, j, T, ge, total: sp["p"][0])

    cfg = CoLearnConfig(n_participants=2, T0=1, max_rounds=3)
    b = tiny_batches(2, 1, 2)
    learner, state = run(cfg, "fused", 1, b)
    learner.schedule = Flat(eta0=0.123)
    with pytest.raises(RuntimeError, match="set_schedule"):
        learner.run_round(state, lambda i, j: b)
    learner.set_schedule(Flat(eta0=0.123))
    state = learner.run_round(state, lambda i, j: b)
    np.testing.assert_allclose(state["log"][-1].lr_last, 0.123, rtol=1e-6)


def test_set_sync_policy_swaps_the_next_T_rule():
    cfg = CoLearnConfig(n_participants=2, T0=1, epsilon=1e9, max_rounds=4)
    b = tiny_batches(2, 1, 2)
    learner, state = run(cfg, "fused", 2, b)
    assert state["ctrl"].T == 2
    learner.set_sync_policy("fle")
    state = learner.run_round(state, lambda i, j: b)
    assert [x.T for x in state["log"]] == [1, 1, 2] and state["ctrl"].T == 2
    assert learner._fused_round.captures == 2


# --- staging and the refused variants ------------------------------------------
def test_stack_epoch_batches_and_stage():
    per_epoch = [tuple(t.numpy() for t in tiny_batches(2, 3, 4, seed=s))
                 for s in range(5)]
    stacked = tengine.stack_epoch_batches(per_epoch, "cpu")
    assert stacked[0].shape == (5, 2, 3, 4, 4)
    assert stacked[1].shape == (5, 2, 3, 4, 1)
    np.testing.assert_array_equal(stacked[0][2].numpy(), per_epoch[2][0])
    want = jengine.stack_epoch_batches(per_epoch)
    np.testing.assert_array_equal(stacked[1].numpy(), np.asarray(want[1]))
    on_dev = tengine.stack_epoch_batches(
        [tiny_batches(2, 3, 4, seed=s) for s in range(2)], "cpu")
    assert on_dev[0].shape == (2, 2, 3, 4, 4)
    s = tengine.stage(3, np.int32, "cpu")
    assert s.dtype == torch.int32 and s.ndim == 0 and int(s) == 3
    t = torch.ones(2)
    assert tengine.stage(t, device="cpu") is t


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A world of one over gloo and its (1,) ``pod`` mesh."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    mesh.init_process_mesh(0, 1, f"file://{tmp_path}/rdv", "gloo", "cpu")
    try:
        yield mesh.make_sim_mesh((1,), ("pod",), "cpu")
    finally:
        dist.destroy_process_group()


def test_unported_fused_variants_raise(one_rank_mesh):
    """Every variant builds, the pod axis too: the pod round and epochs
    build over an aggregate built against the mesh (and refuse one that is
    not), the four pod fused means build and refuse a local stack of more
    than one row; every live, gated and masked combination builds, and the
    live loss mean weighs the live rows."""
    from repro_torch.optim.optimizers import get_optimizer
    opt = get_optimizer("sgd")
    agg = tapi.FullAverage().make_aggregate_fn(tapi.FlatFusedInt8(),
                                               mesh=one_rank_mesh)
    assert callable(tengine.make_fused_round(
        tiny_loss, opt, spmd_axis_name="pod", aggregate_fn=agg))
    assert callable(tengine.make_fused_epochs(tiny_loss, opt,
                                              spmd_axis_name="pod"))
    with pytest.raises(ValueError, match="mesh"):
        tengine.make_fused_round(tiny_loss, opt, spmd_axis_name="pod")
    with pytest.raises(ValueError, match="spmd_axis_name"):
        tengine.make_fused_round(tiny_loss, opt, aggregate_fn=agg)
    two_rows = {"w": torch.ones((2, 256))}
    for weighted in (False, True):
        for stateful in (False, True):
            fn = tengine.make_fused_compressed_average(
                mesh=one_rank_mesh, weighted=weighted, stateful=stateful)
            args = ((torch.ones(1),) if weighted else ()) + (
                (torch.zeros((2, 2048)),) if stateful else ())
            with pytest.raises(ValueError, match="one participant row"):
                fn(two_rows, *args)
    for kw in ({"live": True}, {"gated": True, "live": True},
               {"masked": True, "live": True}):
        assert callable(tengine.make_fused_round(tiny_loss, opt, **kw))
        assert callable(tengine.make_fused_finalize(
            opt, **{k: v for k, v in kw.items() if k != "masked"}))
    assert callable(tengine.make_fused_epochs(tiny_loss, opt, live=True))
    assert tapi._live_loss_means([[1.0, 2.0]], np.array([True, False])) \
        == [1.0]
    assert tapi._live_loss_means([[1.0, 2.0]], np.ones(2)) == [1.5]


def test_fused_finalize_writes_in_place_like_the_legacy_pair():
    """The finalize over the legacy compress/average pair: the mean goes
    into the given params, the new shared model into ``old_avg`` after
    Eq. 4 has read it."""
    from repro_torch.optim.optimizers import get_optimizer
    g = torch.Generator().manual_seed(3)
    stacked = {"w": torch.randn((4, 3, 256), generator=g),
               "v": torch.randn((4, 512), generator=g)}
    old_avg = {"w": torch.zeros((3, 256)), "v": torch.ones(512)}
    want_mean = tree_map(lambda t: t.mean(0), stacked)
    want_rel = tsched.relative_change(want_mean, old_avg)
    fin = tengine.make_fused_finalize(get_optimizer("sgd"))
    out_p, out_o, rel, new_avg = fin(stacked, (), old_avg)
    assert out_p is stacked and new_avg is old_avg
    assert max_diff(new_avg, want_mean) <= 1e-6
    assert max_diff(tree_map(lambda t: t[2], stacked), want_mean) <= 1e-6
    np.testing.assert_allclose(float(rel), want_rel, rtol=1e-6)


# --- port fused == JAX fused, smoke transformer ----------------------------------
K, ROUNDS = 3, 3


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, segments=((("gqa:dense",), 1),))
    x, y = lm_examples(0, 24, 16, cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K, 0), batch_size=4)
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, data, jax.tree.map(np.asarray, params)


def _quantum(stacked, bits):
    buf = jfb.flatten(stacked, jfb.make_layout(stacked))
    _, scale, _ = jref.quantize_blockwise_ref(buf, bits=bits)
    live = jnp.abs(buf.reshape(-1, 256)).max(axis=1) > 0
    return float(jnp.max(jnp.where(live, scale, 0.0))) / K


@pytest.mark.parametrize("codec", [
    ("exact", {}), ("fused", {"bits": 8}), ("leafwise", {"bits": 8}),
    ("fused", {"bits": 4, "error_feedback": True})])
def test_fused_round_matches_jax_fused(smoke, codec):
    """Three rounds (ε = 0.5: T 1, 1, 2) through both packages' fused
    engines from the same params and batches."""
    cfg, data, params_np = smoke
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=0.5,
                         max_rounds=ROUNDS)
    spec, kw = codec
    jl = JCoLearner(ccfg, lambda p, b: jtr.loss_fn(
        p, cfg, {"tokens": b[0], "labels": b[1]}),
        codec=japi.get_codec(spec, **kw), round_engine="fused")
    tl = TCoLearner(ccfg, lambda p, b: ttr.loss_fn(
        p, cfg, {"tokens": b[0], "labels": b[1]}),
        codec=tapi.get_codec(spec, **kw), round_engine="fused",
        device="cpu")
    js = jl.init(jax.tree.map(jnp.asarray, params_np))
    ts = tl.init(params_from_numpy(params_np, "cpu"))
    for _ in range(ROUNDS):
        js = jl.run_round(js, lambda i, j: tuple(
            map(np.asarray, data.epoch_batches(i, j))))
        ts = tl.run_round(ts, lambda i, j: tuple(
            map(torch.as_tensor, data.epoch_batches(i, j))))
    assert [x.T for x in ts["log"]] == [1, 1, 2]
    logs_close(js, ts)
    assert tl._fused_round.captures == 2
    tol = 1e-5 if spec == "exact" else _quantum(js["params"],
                                                kw.get("bits", 8))
    diff = max(float(np.abs(t.numpy() - np.asarray(j)).max())
               for t, j in zip(leaves(ts["params"]),
                               jax.tree.leaves(js["params"])))
    assert diff <= tol
    if kw.get("error_feedback"):
        res = np.abs(ts["residual"].numpy() - np.asarray(js["residual"]))
        assert res.max() <= tol
