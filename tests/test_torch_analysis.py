"""tracelint and the runtime guards of the port (``repro_torch.analysis``),
the torch form of ``tests/test_analysis.py``.

Each AST rule gets a fixture it must flag and one it must stay quiet on,
in torch form (captures through ``GraphSet.capture``, ``Captured``,
``torch.cuda.graph`` / ``CUDAGraph`` and the engine's ``make_fused_*``
builders; host syncs as ``.item()`` / ``.cpu()`` / ``.tolist()`` /
``.numpy()`` / ``float()`` / ``np.asarray``); TL005/TL006 run on
deliberately broken inputs (a protocol-incomplete registrant, fabricated
state-key sets) and over the port's own registries and sources. The
self-run is the acceptance bar: ``src/repro_torch`` lints clean against
the empty committed baseline. The guards' semantics run on the CPU over
``core/graphs.Captured`` (which counts on the CPU the keys the card
would capture); ``no_transfer`` is a no-op on the CPU and is held on
the card in ``tests/test_torch_gpu.py``.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch
from repro_torch.analysis import guards, tracelint
from repro_torch.core import graphs

SRC = repro_torch.__path__[0]


def rules_of(findings):
    return sorted({f.rule for f in findings})


def lint(src):
    return tracelint.lint_source(textwrap.dedent(src))


# -- TL001: a capture built inside a loop body --------------------------------

TL001_BAD = """
    from repro_torch.core.graphs import GraphSet

    def run_rounds(step, xs, dev):
        out = []
        for x in xs:
            fn = GraphSet(dev).capture(step, "step")   # a capture a round
            out.append(fn(x))
        return out
"""

TL001_GOOD = """
    from repro_torch.core.graphs import GraphSet

    def run_rounds(step, xs, dev):
        fn = GraphSet(dev).capture(step, "step", inputs=(0,))
        return [fn(x) for x in xs]
"""


def test_tl001_flags_capture_in_loop():
    findings = lint(TL001_BAD)
    assert "TL001" in rules_of(findings)
    assert any("capture" in f.message and f.rule == "TL001"
               for f in findings)


def test_tl001_quiet_on_hoisted_capture():
    assert lint(TL001_GOOD) == []


@pytest.mark.parametrize("src", [
    """
    def build(codec, specs):
        fns = []
        for spec in specs:
            fns.append(codec.make_fused_mean(spec))
        return fns
    """,
    """
    import torch

    def record(fns):
        return [torch.cuda.CUDAGraph() for f in fns]
    """,
    """
    import torch

    def record(g, fns):
        for f in fns:
            with torch.cuda.graph(g):
                f()
    """,
    """
    from repro_torch.core.graphs import Captured

    def wrap(owner, fns):
        return [Captured(owner, f, "f") for f in fns]
    """])
def test_tl001_flags_every_capture_builder(src):
    assert rules_of(lint(src)) == ["TL001"]


def test_tl001_quiet_when_the_loop_is_outside_the_def():
    # the def owns the builder call: a host loop calling make() reuses it
    assert "TL001" not in rules_of(lint("""
        def make(graphs, step):
            return graphs.capture(step, "step")

        for cfg in range(3):
            def run(graphs, step):
                return graphs.capture(step, "step")
    """))


# -- TL002: host sync reachable from captured code ----------------------------

TL002_BAD = """
    def round_metrics(graphs, state):
        def body(state):
            loss = state["loss"]
            return float(loss.item())      # blocking sync inside a capture
        return graphs.capture(body, "metrics")(state)
"""

TL002_GOOD = """
    def report(graphs, state):
        fn = graphs.capture(lambda s: s["loss"] * 1, "metrics")
        # a host sync OUTSIDE captured code is fine (the round's one fetch)
        return float(fn(state))
"""


def test_tl002_flags_host_sync_in_captured():
    assert "TL002" in rules_of(lint(TL002_BAD))


def test_tl002_quiet_when_sync_is_outside():
    assert lint(TL002_GOOD) == []


def test_tl002_follows_transitive_calls():
    findings = lint("""
        import numpy as np

        def helper(x):
            return np.asarray(x)          # reached from the captured body

        def body(carry, x):
            return carry, helper(x)

        def build(graphs):
            return graphs.capture(body, "scan")
    """)
    assert "TL002" in rules_of(findings)


@pytest.mark.parametrize("sync", ["token.cpu()", "token.tolist()",
                                  "token.numpy()", "int(pos)",
                                  "bool(token.any())"])
def test_tl002_flags_each_sync_in_a_root_by_name(sync):
    """The decode step (and the round, epochs and finalize bodies) are
    captured by name, wherever they are handed to a capture."""
    findings = lint(f"""
        def decode_step(params, cache, token, pos):
            x = {sync}
            return x, cache
    """)
    assert rules_of(findings) == ["TL002"]


def test_tl002_quiet_on_constants_and_host_functions():
    assert lint("""
        def decode_step(params, cache, token, pos):
            return token * float(2), cache

        def report(x):
            return x.item(), x.cpu(), float(x)
    """) == []


# -- TL003: captured fn closing over loop-carried data -------------------------

TL003_BAD = """
    def train(graphs, rounds, xs):
        outs = []
        for w in rounds:
            def step(x):
                return x * w               # w baked in: a capture a round
            outs.append(graphs.capture(step, "step")(xs))
        return outs
"""

TL003_GOOD = """
    def train(graphs, rounds, xs):
        step = graphs.capture(lambda x, w: x * w, "step", inputs=(1,))
        return [step(xs, w) for w in rounds]
"""

TL003_GOOD_REBIND = """
    def train(graphs, rounds, xs):
        outs = []
        for w in rounds:
            def step(x, _w=w):             # sanctioned: default-arg rebind
                return x * _w
            outs.append(graphs.capture(step, "step"))
        return outs
"""


def test_tl003_flags_loop_closure():
    findings = lint(TL003_BAD)
    assert "TL003" in rules_of(findings)
    assert any("loop-carried w" in f.message for f in findings
               if f.rule == "TL003")


def test_tl003_quiet_on_argument_threading():
    assert "TL003" not in rules_of(lint(TL003_GOOD))


def test_tl003_quiet_on_default_arg_rebind():
    assert "TL003" not in rules_of(lint(TL003_GOOD_REBIND))


def test_tl003_ignores_loops_inside_the_capture():
    # a loop INSIDE a captured fn is unrolled into one graph
    assert "TL003" not in rules_of(lint("""
        def build(graphs):
            def run(xs):
                acc = 0.0
                for i in range(4):
                    def body(x):
                        return x + i
                    acc = acc + body(xs)
                return acc
            return graphs.capture(run, "run")
    """))


# -- TL004: no torch form ------------------------------------------------------

def test_tl004_has_no_torch_form_and_says_why():
    """PyTorch has no buffer donation; the linter names why the rule is
    absent instead of flagging anything."""
    assert "TL004" not in tracelint.RULES
    doc = " ".join(tracelint.__doc__.split())
    assert "TL004" in doc and "has no buffer donation" in doc
    assert lint("""
        def bind(round_fn):
            return round_fn
    """) == []


# -- suppression + baseline ----------------------------------------------------

def test_inline_suppression_same_line_and_line_above():
    src = """
        def run(graphs, step, xs):
            for x in xs:
                fn = graphs.capture(step, "s")  # tracelint: disable=TL001 -- bench harness
                fn(x)
    """
    assert lint(src) == []
    src_above = """
        def run(graphs, step, xs):
            for x in xs:
                # tracelint: disable=TL001 -- bench harness
                fn = graphs.capture(step, "s")
                fn(x)
    """
    assert lint(src_above) == []


def test_suppression_is_rule_specific():
    src = """
        def run(graphs, step, xs):
            for x in xs:
                fn = graphs.capture(step, "s")  # tracelint: disable=TL002 -- wrong rule
                fn(x)
    """
    assert "TL001" in rules_of(lint(src))


def test_baseline_filters_by_key(tmp_path):
    fixture = tmp_path / "bad.py"
    fixture.write_text(textwrap.dedent(TL001_BAD))
    findings = tracelint.run_paths([str(fixture)], baseline=None,
                                   project_rules=False)
    assert findings, "fixture must produce findings to baseline"
    base = tmp_path / "baseline.txt"
    base.write_text("# fixture baseline\n"
                    + "\n".join(f.key() for f in findings) + "\n")
    assert tracelint.run_paths([str(fixture)], baseline=str(base),
                               project_rules=False) == []


def test_committed_baseline_is_empty():
    assert tracelint.load_baseline(tracelint.DEFAULT_BASELINE) == set(), \
        "tracelint_baseline.txt must stay empty: fix hazards or suppress " \
        "inline with a reason"


def test_every_inline_suppression_in_the_port_gives_a_reason():
    for path in tracelint.iter_py_files([SRC]):
        with open(path) as fh:
            for n, text in enumerate(fh, 1):
                if "tracelint: disable=" in text and "lint_source" not in text:
                    assert "-- " in text.split("tracelint: disable=")[1], \
                        f"{path}:{n}"


# -- TL005: registry conformance -------------------------------------------------

def test_tl005_project_registries_conform():
    assert tracelint.check_registries() == []


def test_tl005_flags_protocol_incomplete_registrant(monkeypatch):
    from repro_torch.core import api

    class HalfCodec:
        stateful = False

        def encode(self, x):
            return x

        def decode(self, x):
            return x
        # missing: roundtrip, wire_bytes, init_state, make_fused_mean

    monkeypatch.setitem(api.CODECS, "broken-fixture", HalfCodec)
    findings = [f for f in tracelint.check_registries()
                if "broken-fixture" in f.message]
    missing = {f.message.split("`")[1] for f in findings
               if "missing protocol method" in f.message}
    assert {"roundtrip", "wire_bytes", "init_state",
            "make_fused_mean"} <= missing


def test_tl005_flags_stateful_codec_without_roundtrip_ef(monkeypatch):
    from repro_torch.core import api

    class StatefulNoEF(api.WireCodec):
        name = "stateful-no-ef"
        stateful = True

        def encode(self, x):
            return x

        def decode(self, x):
            return x

        def roundtrip(self, x):
            return x

        def wire_bytes(self, tree):
            return 0

        def init_state(self, tree):
            return None

        def make_fused_mean(self, *a, **k):
            raise NotImplementedError

    monkeypatch.setitem(api.CODECS, "stateful-no-ef", StatefulNoEF)
    findings = [f for f in tracelint.check_registries()
                if "stateful-no-ef" in f.message]
    assert any("roundtrip_ef" in f.message for f in findings)


def test_tl005_flags_a_missing_live_hook(monkeypatch):
    from repro_torch.core import topology

    class NoLive(topology.RingTopology):
        def mixing_matrix(self, k):          # drops the live= hook
            return super().mixing_matrix(k)

    monkeypatch.setitem(topology.TOPOLOGIES, "no-live-fixture", NoLive)
    findings = [f for f in tracelint.check_registries()
                if "no-live-fixture" in f.message]
    assert any("`live=`" in f.message for f in findings)


# -- TL006: state-key consistency --------------------------------------------------

def test_tl006_project_state_keys_consistent():
    assert tracelint.check_project_state_keys() == []


def test_tl006_flags_unpersisted_threaded_key():
    findings = tracelint.check_state_keys(
        threaded={"params", "opt", "shiny_new_key"},
        io_keys={"params", "opt"},
        restart_keys={"params", "opt"},
        runner_keys={"params", "opt"})
    assert [f.rule for f in findings] == ["TL006"]
    assert "shiny_new_key" in findings[0].message


def test_tl006_flags_per_slot_key_missing_from_restart_and_runners():
    findings = tracelint.check_state_keys(
        threaded={"params", "opt", "residual"},
        io_keys={"params", "opt", "residual"},
        restart_keys={"params", "opt"},      # residual not reset
        runner_keys={"params", "opt"})       # residual not carried
    msgs = " | ".join(f.message for f in findings)
    assert "restart_participant" in msgs and "select-live" in msgs
    assert all("residual" in f.message for f in findings)


def test_tl006_ephemeral_keys_are_exempt():
    assert tracelint.check_state_keys(
        threaded={"params", "log"}, io_keys={"params"},
        restart_keys={"params"}, runner_keys={"params"}) == []


# -- self-run: the port lints clean -----------------------------------------------

def test_src_repro_torch_lints_clean():
    """The acceptance bar: every hazard in src/repro_torch is fixed or
    carries an inline reason, with the committed baseline empty."""
    findings = tracelint.run_paths([SRC])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_cli_exit_codes(tmp_path, capsys):
    assert tracelint.main([SRC, "--no-project-rules"]) == 0
    assert "tracelint: clean" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(TL001_BAD))
    assert tracelint.main([str(bad), "--no-project-rules",
                           "--baseline", str(tmp_path / "none.txt")]) == 1


def test_module_entry_point_exits_zero_on_the_port():
    """``python -m repro_torch.analysis.tracelint src/repro_torch``, the
    project rules included."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.tracelint", SRC],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "tracelint: clean" in out.stdout


# -- runtime guards (CPU: the capture counts; no_transfer is a no-op) ----------

def _doubler(limit=None):
    """A ``Captured`` on the CPU whose argument is a copied input: one key
    per layout, as on the card."""
    return graphs.GraphSet("cpu").capture(lambda x: x * 2, "doubler",
                                          inputs=(0,), limit=limit)


def test_no_retrace_allows_budget_and_raises_before_capturing_past_it():
    step = guards.no_retrace(_doubler(), limit=1, what="doubler")
    assert step.compile_count() == 0
    step(torch.ones(3))
    assert torch.equal(step(torch.zeros(3)), torch.zeros(3))
    assert step.compile_count() == 1            # same layout: no capture
    with pytest.raises(guards.RetraceError, match="doubler.*limit of 1"):
        step(torch.ones(4))                     # a second layout
    assert step.compile_count() == 1            # raised before capturing
    assert step.check() == 1


def test_assert_compile_count_names_the_function():
    fn = _doubler()
    fn(torch.ones(2))
    assert guards.assert_compile_count(fn, 1, "incr") == 1
    fn(torch.ones(3))
    with pytest.raises(guards.RetraceError, match="incr"):
        guards.assert_compile_count(fn, 1, "incr")


def test_compile_count_reads_every_holder_of_graphs():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving.loop import ServeLoop
    raw, wrapped = _doubler(), guards.no_retrace(_doubler(), limit=2)
    raw(torch.ones(1))
    wrapped(torch.ones(1))
    assert guards.compile_count(raw) == 1
    assert guards.compile_count(wrapped) == 1
    assert guards.compile_count(raw.owner) == 1           # its GraphSet
    cfg = get_smoke_config("internlm2-1.8b")
    loop = ServeLoop(cfg, tr.init_params(0, cfg, torch.float32, "cpu"),
                     batch=1, max_seq=8, device="cpu")
    assert guards.compile_count(loop) == loop.compile_count() == 1
    with pytest.raises(TypeError, match="no captured graphs"):
        guards.compile_count(lambda x: x)


def test_recapture_error_is_a_retrace_error():
    fn = _doubler(limit=1)
    fn(torch.ones(2))
    with pytest.raises(guards.RetraceError, match="limit of 1"):
        fn(torch.ones(5))
    assert issubclass(graphs.RecaptureError, guards.RetraceError)


def test_no_transfer_is_a_no_op_on_the_cpu():
    """No host<->device boundary on the CPU: the block runs as is (the
    card's test holds the guard)."""
    x = torch.ones(3)
    with guards.no_transfer("cpu"):
        assert x.sum().item() == 3.0
    with graphs.GraphSet("cpu").no_sync():
        assert float(x[0]) == 1.0
