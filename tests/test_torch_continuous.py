"""Continuous operation in the port against the JAX package, on the CPU:
``CoLearner.run_round``'s ``on_round_end`` hook, the drifting stream
through both round engines, resume under drift from either package's
checkpoint, the slice as a whole (stream + learner + bank + serving loop)
and the continuous CLI (``repro_torch.launch.continuous``).

Shaped after ``tests/test_serving.py``'s continuous-operation tests.
Tolerances: trajectories (losses, ``rel``, T, rates), published snapshots
within 1e-5, sync patterns, bills, versions and served tokens exact. A
gated run first asserts that each round's divergence clears δ by more
than 5% of δ (``tests/test_torch_policies.py``), so the pattern does not
hang on the last digits of f32 arithmetic.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_smoke_config
from repro.configs.base import CoLearnConfig
from repro.core import api as japi
from repro.core.colearn import CoLearner as JCoLearner
from repro.data import stream as jstream
from repro.launch import continuous as jcont
from repro.models import transformer as jtr
from repro.serving import ModelBank as JBank
from repro.serving import ServeLoop as JLoop
from repro_torch.checkpoint import io as tio
from repro_torch.core import api as tapi
from repro_torch.core import membership as tM
from repro_torch.core.colearn import CoLearner as TCoLearner
from repro_torch.data import partition as part_mod
from repro_torch.data import stream as tstream
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples
from repro_torch.launch import continuous as tcont
from repro_torch.launch.train import epoch_batches_fn, make_loss_fn
from repro_torch.models import transformer as ttr
from repro_torch.serving import ModelBank, ServeLoop
from repro_torch.tree import leaves

TOL = {"rtol": 1e-5, "atol": 1e-5}
MARGIN = 0.05


def cls_data(n=48, d=4, C=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, C, size=n).astype(np.int64)
    return x, y


def lin_params(key=0, d=4, C=3):
    w = jax.random.normal(jax.random.PRNGKey(key), (d, C))
    return {"w": np.asarray(w), "b": np.zeros((C,), np.float32)}


def jloss(params, batch):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    lp = jax.nn.log_softmax(logits, -1)
    return -jnp.take_along_axis(lp, y[..., None], -1).mean(), {}


def tloss(params, batch):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    lp = torch.log_softmax(logits, -1)
    return -torch.take_along_dim(lp, y[..., None], -1).mean(), {}


def tiny_lm():
    return get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, segments=((("gqa:dense",), 1),))


def t_batches(stream, steps=0):
    return epoch_batches_fn(stream, "cpu", steps)


def j_batches(stream, steps=0):
    def fn(i, j):
        bx, by = stream.epoch_batches(i, j)
        if steps:
            bx, by = bx[:, :steps], by[:, :steps]
        return jnp.asarray(bx), jnp.asarray(by)
    return fn


# --- the hook ------------------------------------------------------------------
def _hook_learner(engine, case):
    """K=3, the linear model on the CPU: ``gated`` = the divergence
    trigger at a δ no round reaches (every round quiet) with T=2 epochs
    in chunks of 1 on the fused engine (the gated split); ``churn`` = slot
    1 down in round 1."""
    cfg = CoLearnConfig(n_participants=3, T0=2 if case == "gated" else 1,
                        eta0=0.1, epochs_rule="fle", max_rounds=3)
    eng = tapi.PythonEngine() if engine == "python" else tapi.FusedEngine(
        chunk=1)
    kw = ({"sync_policy": tapi.DivergenceTrigger(delta=1e9)}
          if case == "gated" else
          {"churn": tM.ScriptedChurn(events=(("crash", 1, 1),
                                             ("rejoin", 2, 1)))})
    return TCoLearner(cfg, tloss, round_engine=eng, device="cpu", **kw)


@pytest.mark.parametrize("engine", ["python", "fused"])
@pytest.mark.parametrize("case", ["gated", "churn"])
def test_hook_fires_once_per_round_after_the_log(engine, case):
    x, y = cls_data(n=48)
    data = (torch.tensor(x).reshape(3, 2, 8, 4),
            torch.tensor(y).reshape(3, 2, 8))
    learner = _hook_learner(engine, case)
    state = learner.init(tio.params_from_numpy(lin_params(), "cpu"))
    seen = []

    def hook(ln, st):
        assert ln is learner
        log = st["log"][-1]
        seen.append((st["round"], len(st["log"]), log.round, log.synced,
                     log.live, id(st)))
    for i in range(3):
        out = learner.run_round(state, lambda r, j: data, on_round_end=hook)
        assert out is state and len(seen) == i + 1
        assert seen[-1][:3] == (i + 1, i + 1, i)
        assert seen[-1][5] == id(out)
    if case == "gated":
        assert [s[3] for s in seen] == [False] * 3       # quiet rounds
        if engine == "fused":
            assert learner._runner._gate.captures == 1
    else:
        assert [s[4] for s in seen] == [3, 2, 3]          # churned round
    # without a hook the round is the same round
    plain = _hook_learner(engine, case)
    ps = plain.init(tio.params_from_numpy(lin_params(), "cpu"))
    for _ in range(3):
        ps = plain.run_round(ps, lambda r, j: data)
    assert torch.equal(ps["params"]["w"], state["params"]["w"])


def test_read_only_hooks_and_drift_capture_nothing():
    """The fused engine over a covariate-drifting token stream, with both
    banks' ``publish_from`` as hooks (a clone of the shared row, a clone of
    the stacked tree): the round graph is captured in round 0 and only
    replayed after, across 4 rounds whose batch contents all differ."""
    cfg = tiny_lm()
    x, y = lm_examples(0, 96, 16, cfg.vocab_size)
    stream = tstream.ShardStream([x, y], 3, 4, 0,
                                 drift=tstream.CovariateDrift(rate=0.25))
    learner = TCoLearner(CoLearnConfig(n_participants=3, T0=1, eta0=0.05,
                                       epochs_rule="fle", max_rounds=4),
                         make_loss_fn(cfg), round_engine="fused",
                         device="cpu")
    state = learner.init(ttr.init_params(0, cfg, torch.float32,
                                         device="cpu"))
    shared, ens = ModelBank(), ModelBank(mode="ensemble")

    def hook(ln, st):
        shared.publish_from(ln, st)
        ens.publish_from(ln, st)
    batches, caps, firsts = t_batches(stream, 2), [], []
    for _ in range(4):
        firsts.append(batches(state["round"], 0)[0].clone())
        state = learner.run_round(state, batches, on_round_end=hook)
        caps.append(learner._runner.graphs.captures)
    assert caps == [1, 1, 1, 1]
    assert learner._fused_round.captures == 1
    assert all(not torch.equal(a, b) for a, b in zip(firsts, firsts[1:]))
    assert shared.version == ens.version == 4
    for a, b in zip(leaves(shared.current().params),
                    leaves(learner.shared_model(state))):
        assert torch.equal(a, b)
    for a, b in zip(leaves(ens.current().params), leaves(state["params"])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# --- the stream through the engines ---------------------------------------------
@pytest.mark.parametrize("engine", ["python", "fused"])
def test_nodrift_training_bit_identical_both_engines(engine):
    """A NoDrift stream trains bit for bit like the frozen stack."""
    x, y = cls_data(n=48)
    cfg = CoLearnConfig(n_participants=2, T0=2, eta0=0.05, epsilon=0.02,
                        max_rounds=3)
    outs = []
    for data in (tstream.ShardStream([x, y], 2, 8, seed=1),
                 ParticipantData(part_mod.shard_by_indices(
                     [x, y], part_mod.scenario_indices(
                         len(x), 2, 1, scenario="iid", labels=y,
                         min_size=8)), 8, 1)):
        learner = TCoLearner(cfg, tloss, round_engine=engine, device="cpu")
        state = learner.init(tio.params_from_numpy(lin_params(), "cpu"))
        for _ in range(3):
            state = learner.run_round(state, t_batches(data))
        outs.append(state["params"])
    for a, b in zip(leaves(outs[0]), leaves(outs[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("drift", ["covariate", "label_shift"])
def test_resume_under_drift_from_either_package(tmp_path, drift):
    """Fused engine, checkpoint after round 2. A fresh port learner and
    stream resumed from the port's checkpoint equal the uninterrupted port
    run bit for bit; resumed from the JAX package's, they equal the JAX
    uninterrupted run within 1e-5."""
    x, y = cls_data(n=48)
    cfg = CoLearnConfig(n_participants=2, T0=2, eta0=0.05, epsilon=0.02,
                        max_rounds=4)

    def make(side):
        mod, CL, loss, conv, batches = (
            (jstream, JCoLearner, jloss,
             lambda t: jax.tree.map(jnp.asarray, t), j_batches)
            if side == "jax" else
            (tstream, TCoLearner, tloss,
             lambda t: tio.params_from_numpy(t, "cpu"), t_batches))
        d = (mod.CovariateDrift(rate=0.3) if drift == "covariate"
             else mod.LabelShift(rate=0.25))
        stream = mod.ShardStream([x, y], 2, 8, seed=2, drift=d)
        kw = {} if side == "jax" else {"device": "cpu"}
        ln = CL(cfg, loss, round_engine="fused", **kw)
        return ln, ln.init(conv(lin_params())), batches(stream)

    def run(ln, st, fn, n):
        for _ in range(n):
            st = ln.run_round(st, fn)
        return st

    ref = {side: run(*make(side), 4) for side in ("torch", "jax")}
    for side, io in (("torch", tio), ("jax", jio)):
        path = str(tmp_path / side)
        io.save_round_state(path, run(*make(side), 2))
        ln, st, fn = make("torch")
        st = run(ln, tio.restore_round_state(path, st), fn, 2)
        assert st["round"] == ref[side]["round"] == 4
        for a, b in zip(leaves(st["params"]), leaves(ref[side]["params"])):
            if side == "torch":
                assert torch.equal(a, b)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# --- the slice as a whole -------------------------------------------------------
DELTA = 0.01       # the divergences run 0.0074-0.0117: >= 14% from δ
ROUNDS = 4


def _slice_run(side, engine, divs=None):
    """Stream (AbruptDrift at round 2) + learner (divergence trigger) +
    bank (publish_from as the hook) + serving loop (poll and generate
    after every round), from JAX-initialised params. Returns the final
    state, every round's published snapshot (numpy) and served tokens."""
    cfg = tiny_lm()
    x, y = lm_examples(0, 96, 16, cfg.vocab_size)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    ccfg = CoLearnConfig(n_participants=3, T0=1, eta0=0.05, epsilon=0.05,
                         max_rounds=ROUNDS)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 4))
    if side == "jax":
        stream = jstream.ShardStream([x, y], 3, 4, 0,
                                     drift=jstream.AbruptDrift(at_round=2))
        policy = japi.DivergenceTrigger(delta=DELTA)
        if divs is not None:
            @dataclasses.dataclass(frozen=True)
            class Recording(japi.DivergenceTrigger):
                def should_sync(self, div, round_i, delta=None):
                    divs.append(float(div))
                    return super().should_sync(div, round_i, delta)
            policy = Recording(delta=DELTA)
        learner = JCoLearner(ccfg, lambda p, b: jtr.loss_fn(
            p, cfg, {"tokens": b[0], "labels": b[1]}),
            round_engine=engine, sync_policy=policy)
        state = learner.init(jp)
        bank = JBank()
        loop = JLoop(cfg, learner.shared_model(state), batch=2, max_seq=16)
        batches, prompts = j_batches(stream, 2), jnp.asarray(prompts,
                                                             jnp.int32)
    else:
        stream = tstream.ShardStream([x, y], 3, 4, 0,
                                     drift=tstream.AbruptDrift(at_round=2))
        learner = TCoLearner(ccfg, make_loss_fn(cfg), round_engine=engine,
                             sync_policy=tapi.DivergenceTrigger(delta=DELTA),
                             device="cpu")
        state = learner.init(tio.params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
        bank = ModelBank()
        loop = ServeLoop(cfg, learner.shared_model(state), batch=2,
                         max_seq=16, device="cpu")
        batches, prompts = t_batches(stream, 2), torch.as_tensor(prompts)
    bank.publish(learner.shared_model(state), round_i=0)
    assert loop.poll(bank)
    snaps, tokens, versions = [], [], []
    for _ in range(ROUNDS):
        state = learner.run_round(state, batches,
                                  on_round_end=bank.publish_from)
        loop.poll(bank)
        gen, _ = loop.generate(prompts, 4)
        snaps.append([np.asarray(t) for t in leaves(bank.current().params)])
        tokens.append(np.asarray(gen))
        versions.append((loop.version, bank.staleness(state["round"])))
    assert loop.compile_count() == 1
    captures = (learner._runner.graphs.captures
                if side == "torch" and engine == "fused" else None)
    return state, snaps, tokens, versions, captures


@pytest.fixture(scope="module")
def jax_slice():
    divs = []
    out = {"python": _slice_run("jax", "python", divs),
           "fused": _slice_run("jax", "fused")}
    return out, divs


@pytest.mark.parametrize("engine", ["python", "fused"])
def test_continuous_slice_matches_jax(jax_slice, engine):
    jruns, divs = jax_slice
    assert len(divs) == ROUNDS
    assert min(abs(d - DELTA) / DELTA for d in divs) > MARGIN, divs
    js, jsnaps, jtok, jver, _ = jruns[engine]
    ts, tsnaps, ttok, tver, caps = _slice_run("torch", engine)
    jl, tl = js["log"], ts["log"]
    assert [x.synced for x in tl] == [x.synced for x in jl] == [
        False, True, False, True]
    assert [x.comm_bytes for x in tl] == [x.comm_bytes for x in jl]
    assert [x.T for x in tl] == [x.T for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.local_losses, a.local_losses, **TOL)
        np.testing.assert_allclose([b.lr_first, b.lr_last],
                                   [a.lr_first, a.lr_last], **TOL)
        np.testing.assert_allclose(b.rel_change, a.rel_change, **TOL)
    assert tver == jver == [(1, 1), (2, 0), (2, 1), (3, 0)]
    for a, b in zip(jsnaps, tsnaps):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_allclose(y, x, **TOL)
    for a, b in zip(jtok, ttok):
        np.testing.assert_array_equal(b, a)
    if engine == "fused":
        assert caps == 3          # the epochs, gate and finalize graphs


# --- the continuous CLI ---------------------------------------------------------
CLI = ["--rounds", "3", "--t0", "1", "--n-examples", "96", "--batch-size",
       "4", "--seq-len", "16", "--steps-per-epoch", "2", "--serve-batch",
       "2", "--prompt-len", "4", "--new-tokens", "4", "--max-seq", "16"]
LINE = re.compile(r"^round (\d+): T=(\d+) local_loss=\S+ serve_loss=\S+ "
                  r"v(\d+) stale=(\d+) (swap [\d.]+ms|no-swap) \d+ tok/s "
                  r"compiles=(\d+)( SKIP\(sync\))? \([\d.]+s\)$")
# the port's divergences at these flags: 0.00141, 0.00223, 0.00148, each
# >= 17% from δ (quiet, synced, quiet)
TRIGGER = ["--sync-policy", "divtrigger", "--trigger-delta", "0.0019",
           "--drift", "abrupt", "--drift-round", "2"]


def _fields(out):
    """The data-independent fields of every round line: round, T,
    version, staleness, swap or not, compiles, skipped."""
    rows = []
    for line in out.splitlines():
        if line.startswith("round "):
            m = LINE.match(line)
            assert m, line
            g = m.groups()
            rows.append((*g[:4], g[4].split()[0], g[5], g[6]))
    return rows


def _data_lines(out):
    """Every line but the header, without the timings (swap ms, tok/s,
    seconds)."""
    lines = out.splitlines()[1:]
    lines = [re.sub(r"swap [\d.]+ms", "swap", x) for x in lines]
    lines = [re.sub(r"\d+ tok/s", "tok/s", x) for x in lines]
    return [re.sub(r" \([\d.]+s\)$", "", x) for x in lines]


@pytest.fixture(scope="module")
def cli_runs():
    """Each configuration once per engine: the port's two engines and the
    JAX CLI (its default fused engine) under ile and fle, and the port's
    two engines under the divergence trigger with abrupt drift."""
    import contextlib
    import io
    out = {}
    for name, flags in (("ile", ["--sync-policy", "ile"]),
                        ("fle", ["--sync-policy", "fle"]),
                        ("divtrigger", TRIGGER)):
        sides = [("fused", tcont.main, ["--device", "cpu"]),
                 ("python", tcont.main, ["--device", "cpu", "--engine",
                                         "python"])]
        if name != "divtrigger":
            sides.append(("jax", jcont.main, []))
        for side, main, extra in sides:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(CLI + flags + extra) == 0
            out[name, side] = buf.getvalue()
    return out


@pytest.mark.parametrize("policy", ["ile", "fle"])
def test_continuous_cli_prints_the_jax_fields(cli_runs, policy):
    want = _fields(cli_runs[policy, "jax"])
    assert len(want) == 3
    assert [r[2:4] for r in want] == [("2", "0"), ("3", "0"), ("4", "0")]
    for engine in ("fused", "python"):
        out = cli_runs[policy, engine]
        assert _fields(out) == want
        assert out.splitlines()[0] == cli_runs[policy, "jax"].splitlines()[
            0].replace("engine=fused", f"engine={engine}")
        assert out.splitlines()[-1] == cli_runs[policy, "jax"].splitlines()[
            -1]


def test_continuous_cli_engines_print_the_same_lines(cli_runs):
    fused = cli_runs["divtrigger", "fused"]
    python = cli_runs["divtrigger", "python"]
    assert _data_lines(fused) == _data_lines(python)
    skipped = [r[6] is not None for r in _fields(fused)]
    assert any(skipped) and not all(skipped), fused
    assert "drift=abrupt sync=divtrigger" in fused.splitlines()[0]


@pytest.mark.parametrize("argv", [
    ["--max-seq", "8", "--prompt-len", "8", "--new-tokens", "8"],
    ["--drift", "none", "--drift-rate", "0.5"],
    ["--drift", "covariate", "--drift-round", "2"],
    ["--drift", "label_shift", "--drift-severity", "0.5"],
    ["--sync-policy", "nope"],
])
def test_continuous_cli_rejects_flags_as_jax(argv, capsys):
    errs = []
    for main, extra in ((tcont.main, ["--device", "cpu"]), (jcont.main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]
