"""Program spans (``repro_torch.spans``) on the CPU: off, they annotate,
record and allocate nothing; on, under a CPU profiler, the ``rt.`` names
nest at the layer boundaries; on or off, the answers are bit-identical.
The device clocks (the round graph's marks, ``step_ms``) and the spans'
device mirrors are held on the card in ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeLoop
from repro_torch.tree import leaves

PROMPT, NEW = 3, 4


@pytest.fixture(autouse=True)
def _off():
    spans.disable()
    yield
    spans.disable()


def _hybrid():
    """Jamba's smoke period: a Mamba layer with an MoE FFN, an attention
    layer with a dense one."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    assert cfg.segments == ((("mamba:moe", "gqa:dense"), 1),)
    return cfg, tr.init_params(0, cfg, torch.float32, device="cpu")


def _tokens(cfg, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=g)


def _prefill(cfg, params):
    return make_prefill_step(cfg)(params, {"tokens": _tokens(cfg, (2, 8))})


def _loop(cfg, params):
    return ServeLoop(cfg, params, batch=2, max_seq=PROMPT + NEW,
                     device="cpu")


def _serve(loop):
    return loop.generate(_tokens(loop.cfg, (2, PROMPT), 1), NEW)


def _round():
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import (build_data, epoch_batches_fn,
                                          make_loss_fn)
    cfg = get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, segments=((("gqa:dense",), 1),))
    data = build_data(cfg, 2, 2, 8, 8, seed=0)
    learner = CoLearner(
        CoLearnConfig(n_participants=2, T0=1, eta0=0.05, max_rounds=1),
        make_loss_fn(cfg), codec=api.get_codec("fused"),
        round_engine="fused", device="cpu")
    state = learner.init(tr.init_params(0, cfg, torch.float32, device="cpu"))
    return learner.run_round(state, epoch_batches_fn(data, "cpu", 2))


def _raise(*a, **k):
    raise AssertionError("tracing is off: nothing may annotate or record")


def test_spans_off_annotate_record_and_keep_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    cfg, params = _hybrid()
    _prefill(cfg, params)
    _, stats = _serve(_loop(cfg, params))
    state = _round()
    assert "step_ms" not in stats
    log = state["log"][-1]
    assert (log.epochs_ms, log.finalize_ms) == (None, None)
    assert spans.span("rt.x") is spans.span("rt.y")     # the shared no-op


def _ranges(prof):
    """(name, start, end) of every ``rt.`` range a CPU profile holds."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("rt.")]


def _inside(ranges, outer):
    """For each range named ``outer``, the names of the ranges inside it
    (itself left out), in start order."""
    out = []
    for n, a, b in sorted(ranges, key=lambda r: r[1]):
        if n == outer:
            out.append([m for m, x, y in sorted(ranges, key=lambda r: r[1])
                        if a <= x and y <= b and (m, x, y) != (n, a, b)])
    return out


def test_spans_nest_at_the_layer_boundaries_under_a_profiler():
    cfg, params = _hybrid()
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _prefill(cfg, params)
    r = _ranges(prof)
    (inner,) = _inside(r, "rt.prefill")
    assert inner == ["rt.embed", "rt.mixer.mamba", "rt.ffn.moe",
                     "rt.moe.route", "rt.moe.experts", "rt.moe.combine",
                     "rt.mixer.attention", "rt.ffn.dense", "rt.head"]
    (moe,) = _inside(r, "rt.ffn.moe")
    assert moe == ["rt.moe.route", "rt.moe.experts", "rt.moe.combine"]


def test_serve_spans_one_step_per_replay_under_a_profiler():
    cfg, params = _hybrid()
    loop = _loop(cfg, params)             # its first step is the capture
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = _serve(loop)
    r = _ranges(prof)
    (pre,) = _inside(r, "rt.serve.prefill")
    (dec,) = _inside(r, "rt.serve.decode")
    assert pre.count("rt.serve.step") == PROMPT
    assert dec.count("rt.serve.step") == NEW
    n_layers = sum(len(p) * n for p, n in cfg.segments)
    assert [n for n, _, _ in r].count("rt.serve.step") == PROMPT + NEW
    # each replay runs every layer: a mixer span per layer per step
    for inner in _inside(r, "rt.serve.step"):
        assert sum(m.startswith("rt.mixer.") for m in inner) == n_layers
        assert sum(m.startswith("rt.ffn.") for m in inner) == n_layers
    assert "step_ms" not in stats          # no card: no device clock


def test_round_spans_name_the_runners_host_phases():
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = _round()
    names = [n for n, _, _ in sorted(_ranges(prof), key=lambda r: r[1])]
    phases = [n for n in names if n.startswith("rt.round.")]
    assert phases == ["rt.round.stage", "rt.round.replay", "rt.round.fetch",
                      "rt.round.finish"]
    log = state["log"][-1]
    assert (log.epochs_ms, log.finalize_ms) == (None, None)   # CPU


def test_answers_are_bit_identical_with_tracing_on_and_off():
    cfg, params = _hybrid()
    runs = []
    for on in (False, True):
        (spans.enable if on else spans.disable)()
        logits = _prefill(cfg, params)
        served, _ = _serve(_loop(cfg, tr.init_params(
            0, cfg, torch.float32, device="cpu")))
        state = _round()
        runs.append((logits, served, leaves(state["params"]),
                     state["log"][-1].local_losses))
    (l0, s0, p0, z0), (l1, s1, p1, z1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    np.testing.assert_array_equal(z0, z1)


def test_marks_and_stamps_are_nothing_off_the_card():
    assert spans.marks("cpu") is None
    spans.record(None, 0)
    assert spans.between(None) is None
    spans.enable()
    assert spans.stamp("cpu") is None
    assert spans.between(None) is None
