"""tracelint — static analysis of the traced-data discipline, ported from
``repro/analysis/tracelint.py`` to the port's captured CUDA graphs.

Run as a module or from pytest (``tests/test_torch_analysis.py``)::

    python -m repro_torch.analysis.tracelint src/repro_torch
    run_paths(["src/repro_torch"]) == []

Rules, in their torch form:

===== ========================= ===========================================
ID    name                      what it flags
===== ========================= ===========================================
TL001 capture-in-loop           a capture built inside a loop body:
                                ``GraphSet.capture`` / ``.capture(...)``,
                                ``Captured(...)``, ``torch.cuda.graph``,
                                ``torch.cuda.CUDAGraph()``,
                                ``make_graphed_callables`` or the engine's
                                ``make_fused_*`` builders: a new graph (and
                                its capture seconds and pool) per
                                iteration.
TL002 host-sync-in-captured     ``.item()`` / ``.cpu()`` / ``.tolist()`` /
                                ``.numpy()`` / ``float()`` / ``int()`` /
                                ``bool()`` / ``np.asarray`` /
                                ``np.array`` in a function reachable from
                                captured code: a blocking device round trip
                                on the round's critical path (inside a
                                capture, an error).
TL003 captured-closure-leak     a captured function defined inside a host
                                loop closing over loop-carried data instead
                                of taking it as an argument: the value is
                                baked into the graph, so every iteration
                                captures again.
TL005 registry-conformance      a registered codec / aggregator / engine /
                                schedule / sync policy / topology / drift /
                                churn object missing part of its protocol
                                surface, the optional ``live=`` /
                                ``events=`` / ``delta=`` / ``weighted=`` /
                                ``stateful=`` hooks included.
TL006 state-key-consistency     a ``state["…"]`` key the runners thread
                                that ``checkpoint/io.py`` does not persist,
                                or that ``restart_participant`` / the
                                runners' live-row plumbing do not handle.
===== ========================= ===========================================

TL004 (the reference's missing-donate) has no torch form: PyTorch has no
buffer donation, and a captured graph writes its state in place by
construction (a replay runs on the storage it was captured on, and
``core/graphs.Captured`` captures again rather than replay on moved
storage), so a round that returned fresh params could not reach a replay.

The captured code (the roots of TL002 and TL003): functions handed to a
capture (a name or a lambda), and the round, epochs, finalize and decode
functions by name (``ROOT_NAMES``), closed over nesting and over calls
to functions of the same module (``foo()`` / ``self.foo()``).

Suppression: append ``# tracelint: disable=TL002 -- reason`` to the
flagged line (or put it on a comment line directly above). The committed
baseline (``tracelint_baseline.txt``) is empty and stays empty: fix the
hazard or justify it inline.

TL001–TL003 are AST passes over the given paths. TL005/TL006 import
``repro_torch`` and reflect over its registries and module sources
(``--no-project-rules`` skips them when linting fixtures).
"""
from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass

# -- findings, suppressions, baseline ----------------------------------------

RULES = {
    "TL001": "capture-in-loop",
    "TL002": "host-sync-in-captured",
    "TL003": "captured-closure-leak",
    "TL005": "registry-conformance",
    "TL006": "state-key-consistency",
}

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "tracelint_baseline.txt")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} ({RULES[self.rule]}) "
                f"{self.message}")

    def key(self) -> str:
        """Baseline key: stable under message rewording, not line drift
        (the baseline is meant to stay empty, not to age gracefully)."""
        return f"{self.rule} {self.path}:{self.line}"


_SUPPRESS_RE = re.compile(r"#\s*tracelint:\s*disable=((?:TL\d{3}[,\s]*)+)")


def _suppressions(source: str) -> dict:
    """line number -> set of rule ids suppressed on that line."""
    out = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = set(re.findall(r"TL\d{3}", m.group(1)))
    return out


def _apply_suppressions(findings, sup):
    """A finding is suppressed by a directive on its own line or on the
    comment line directly above it."""
    return [f for f in findings
            if f.rule not in sup.get(f.line, set()) | sup.get(f.line - 1,
                                                               set())]


def load_baseline(path: str) -> set:
    if not os.path.exists(path):
        return set()
    with open(path) as fh:
        return {line.strip() for line in fh
                if line.strip() and not line.startswith("#")}


# -- AST helpers -------------------------------------------------------------

def _dotted(node):
    """'torch.cuda.graph' for an Attribute chain, 'f' for a Name, else
    None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _tail(node):
    """The called name: 'capture' for ``self.graphs.capture``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _annotate_parents(tree):
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._tl_parent = node


def _ancestors(node):
    node = getattr(node, "_tl_parent", None)
    while node is not None:
        yield node
        node = getattr(node, "_tl_parent", None)


_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

#: calls (by their last name) whose function-valued arguments are
#: captured: the roots of TL002 / TL003; each also builds a capture
#: (TL001), as do the CUDA graph objects and the engine's builders
CAPTURE_CALLS = {"capture", "Captured", "make_graphed_callables"}
_CAPTURE_DOTTED = {"torch.cuda.graph", "torch.cuda.CUDAGraph",
                   "cuda.graph", "cuda.CUDAGraph"}
_BUILDER_TAIL_RE = re.compile(r"^make_fused_\w+$")
#: functions captured by name: the engine's round, epochs and finalize
#: bodies and the decode steps
ROOT_NAMES = re.compile(
    r"^(round_(body|graph)|epochs?_(fn|body|from_zero)|scan_epochs"
    r"|g?finalize(_\w+)?|decode_step|\w+_decode)$")

#: host-sync calls flagged by TL002 inside captured-reachable functions
HOST_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                   "numpy.array"}
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_SYNC_BUILTINS = {"float", "int", "bool"}


def _is_capture(call: ast.Call) -> bool:
    t = _tail(call.func)
    if _dotted(call.func) in _CAPTURE_DOTTED or t in CAPTURE_CALLS:
        return True
    return bool(t and _BUILDER_TAIL_RE.match(t))


def _in_subtree(node, root):
    if root is None:
        return False
    while node is not None:
        if node is root:
            return True
        node = getattr(node, "_tl_parent", None)
    return False


def _assigned_names(node, *, skip=None):
    """All names bound anywhere under ``node`` (assignments, loop targets,
    with-targets, comprehension targets), excluding the ``skip``
    subtree."""
    names = set()
    for n in ast.walk(node):
        if _in_subtree(n, skip):
            continue
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            names.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(n.name)
    return names


def _func_params(fn):
    args = fn.args
    names = [a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return set(names)


def _walk_body(fn):
    """Walk a function's *body* only: default values and decorators
    evaluate at definition time in the enclosing scope (``def f(x,
    _w=w)`` is the sanctioned fix for TL003, not a closure)."""
    for stmt in (fn.body if isinstance(fn.body, list) else [fn.body]):
        yield from ast.walk(stmt)


def _free_names(fn):
    """Names loaded in ``fn``'s body that ``fn`` does not bind itself."""
    bound = set(_func_params(fn))
    loaded = set()
    for n in _walk_body(fn):
        if isinstance(n, ast.Name):
            if isinstance(n.ctx, ast.Store):
                bound.add(n.id)
            elif isinstance(n.ctx, ast.Load):
                loaded.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(n.name)
    return loaded - bound


# -- per-module linter (TL001-TL003) -----------------------------------------

class ModuleLinter:
    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        _annotate_parents(self.tree)
        self.findings = []

    def run(self):
        self._collect_captured()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._tl001(node)
        self._tl002()
        self._tl003()
        return _apply_suppressions(self.findings, _suppressions(self.source))

    def _flag(self, rule, node, message):
        self.findings.append(
            Finding(rule, self.path, getattr(node, "lineno", 1), message))

    # -- TL001: capture built inside a loop body ---------------------------
    def _tl001(self, call):
        if not _is_capture(call):
            return
        for anc in _ancestors(call):
            if isinstance(anc, _FUNCS + (ast.ClassDef,)):
                return  # the enclosing def owns the call
            if isinstance(anc, _LOOPS + _COMPS):
                self._flag("TL001", call,
                           f"`{ast.unparse(call.func)}` built inside a "
                           "loop body: a new capture (its seconds and its "
                           "graph pool) per iteration. Build it once "
                           "outside and pass per-iteration values as "
                           "data in its static buffers.")
                return

    # -- captured-function discovery (shared by TL002/TL003) ----------------
    def _collect_captured(self):
        self.functions = [n for n in ast.walk(self.tree)
                          if isinstance(n, _FUNCS)]
        by_name = {}
        for fn in self.functions:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(fn.name, []).append(fn)
        roots = set()
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and _tail(node.func) in CAPTURE_CALLS):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    roots.add(arg)
                elif isinstance(arg, ast.Name):
                    roots.update(by_name.get(arg.id, ()))
        for name, fns in by_name.items():
            if ROOT_NAMES.match(name):
                roots.update(fns)
        self.roots = set(roots)

        # close over nesting and intra-module calls (self.foo() / foo())
        captured = set(roots)
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                if fn not in captured and any(
                        a in captured for a in _ancestors(fn)
                        if isinstance(a, _FUNCS)):
                    captured.add(fn)
                    changed = True
            for fn in list(captured):
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = None
                    if isinstance(node.func, ast.Name):
                        callee = node.func.id
                    elif (isinstance(node.func, ast.Attribute)
                          and isinstance(node.func.value, ast.Name)
                          and node.func.value.id in ("self", "cls")):
                        callee = node.func.attr
                    for target in by_name.get(callee, ()):
                        if target not in captured:
                            captured.add(target)
                            changed = True
        self.captured = captured

    # -- TL002: host syncs reachable from captured code ---------------------
    def _tl002(self):
        seen = set()
        for fn in self.captured:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or node.lineno in seen:
                    continue
                d = _dotted(node.func)
                hit = None
                if d in HOST_SYNC_CALLS and node.args:
                    hit = d
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in HOST_SYNC_METHODS):
                    hit = f".{node.func.attr}()"
                elif (d in HOST_SYNC_BUILTINS and node.args
                      and not isinstance(node.args[0], ast.Constant)):
                    hit = f"{d}()"
                if hit:
                    seen.add(node.lineno)
                    self._flag("TL002", node,
                               f"host sync `{hit}` inside a function "
                               "reachable from captured code: a blocking "
                               "device round trip on the round's critical "
                               "path (an error inside a capture). Keep "
                               "values on the device and fetch once, "
                               "outside.")

    # -- TL003: captured fn closing over loop-carried data -------------------
    def _tl003(self):
        for fn in self.roots:
            # a function nested in captured code is unrolled inside one
            # capture: only roots can leak host-loop data
            if any(a in self.captured for a in _ancestors(fn)
                   if isinstance(a, _FUNCS)):
                continue
            free = _free_names(fn)
            if not free:
                continue
            for anc in _ancestors(fn):
                if isinstance(anc, _LOOPS):
                    loop_names = _assigned_names(anc, skip=fn)
                    if isinstance(anc, (ast.For, ast.AsyncFor)):
                        loop_names |= {n.id for n in ast.walk(anc.target)
                                       if isinstance(n, ast.Name)}
                    leaked = sorted(free & loop_names)
                    if leaked:
                        self._flag(
                            "TL003", fn,
                            f"captured function closes over loop-carried "
                            f"{', '.join(leaked)}: the value is baked "
                            "into the graph, so every iteration captures "
                            "again. Pass it as an argument (a static "
                            "buffer) instead.")
                        break


def lint_source(source: str, path: str = "<fixture>"):
    """AST rules (TL001-TL003) over one source string — the test hook."""
    return ModuleLinter(path, source).run()


def lint_file(path: str):
    with open(path) as fh:
        return lint_source(fh.read(), path)


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


# -- TL005: registry conformance (runtime reflection) ------------------------

def _accepts(fn, kwarg):
    import inspect
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True
    return kwarg in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _locate(cls):
    import inspect
    try:
        path = inspect.getsourcefile(cls) or "<unknown>"
        line = inspect.getsourcelines(cls)[1]
    except (OSError, TypeError):
        path, line = "<unknown>", 1
    return path, line


def check_registries():
    """Every registered object implements its full protocol surface,
    including the optional hooks the runners rely on (``live=`` liveness
    rows, ``events=`` membership events, ``delta=`` gate overrides,
    ``weighted=`` / ``stateful=`` fused-mean variants). A registered
    object missing one of them degrades silently: the runner falls back
    to the plain call shape."""
    from repro_torch.core import api, membership, topology
    from repro_torch.data import stream

    findings = []

    def require(obj, registry, name, cond, what):
        if not cond:
            path, line = _locate(type(obj))
            findings.append(Finding(
                "TL005", path, line,
                f"{registry}[{name!r}] ({type(obj).__name__}) {what}"))

    def methods(obj, registry, name, *names):
        for m in names:
            require(obj, registry, name, callable(getattr(obj, m, None)),
                    f"missing protocol method `{m}`")

    def kw(obj, registry, name, method, kwarg):
        fn = getattr(obj, method, None)
        require(obj, registry, name, fn is None or _accepts(fn, kwarg),
                f"`{method}` does not accept the `{kwarg}=` hook")

    for name, factory in api.CODECS.items():
        c = factory()
        methods(c, "CODECS", name, "encode", "decode", "roundtrip",
                "wire_bytes", "init_state", "make_fused_mean")
        require(c, "CODECS", name, hasattr(c, "stateful"),
                "missing `stateful` attribute")
        for hook in ("weighted", "stateful"):
            kw(c, "CODECS", name, "make_fused_mean", hook)
        if getattr(c, "stateful", False):
            require(c, "CODECS", name,
                    type(c).roundtrip_ef is not api.WireCodec.roundtrip_ef,
                    "is stateful but does not override `roundtrip_ef` "
                    "(error feedback would silently no-op)")

    for name, factory in api.AGGREGATORS.items():
        a = factory()
        methods(a, "AGGREGATORS", name, "mixing_matrix",
                "make_aggregate_fn", "comm_bytes", "init_round_state")
        for attr in ("stateful", "uses_weights", "static_comm"):
            require(a, "AGGREGATORS", name, hasattr(a, attr),
                    f"missing `{attr}` attribute")
        kw(a, "AGGREGATORS", name, "mixing_matrix", "live")
        kw(a, "AGGREGATORS", name, "comm_bytes", "live")
        kw(a, "AGGREGATORS", name, "make_aggregate_fn", "dynamic")

    for name, factory in api.ENGINES.items():
        methods(factory(), "ENGINES", name, "bind")

    for name, factory in api.SCHEDULES.items():
        s = factory()
        methods(s, "SCHEDULES", name, "lr", "round_params",
                "device_round_params")
        require(s, "SCHEDULES", name,
                callable(getattr(s, "traced_lr", None)),
                "missing the `traced_lr` body the fused engine captures")

    for name, factory in api.SYNC_POLICIES.items():
        p = factory()
        methods(p, "SYNC_POLICIES", name, "init_state", "update",
                "should_sync", "round_delta", "epochs_budget")
        require(p, "SYNC_POLICIES", name, hasattr(p, "divergence_gated"),
                "missing `divergence_gated` attribute")
        require(p, "SYNC_POLICIES", name,
                callable(getattr(p, "traced_should_sync", None)),
                "missing the `traced_should_sync` gate the fused engine "
                "captures")
        kw(p, "SYNC_POLICIES", name, "update", "events")
        kw(p, "SYNC_POLICIES", name, "should_sync", "delta")
        kw(p, "SYNC_POLICIES", name, "round_delta", "events")

    for name, factory in topology.TOPOLOGIES.items():
        t = factory()
        methods(t, "TOPOLOGIES", name, "adjacency", "mixing_matrix",
                "edge_perms", "spectral_gap", "validate", "period")
        require(t, "TOPOLOGIES", name, hasattr(t, "time_varying"),
                "missing `time_varying` attribute")
        kw(t, "TOPOLOGIES", name, "mixing_matrix", "live")

    for name, cls in stream.DRIFTS.items():
        d = cls()
        methods(d, "DRIFTS", name, "transform")
        require(d, "DRIFTS", name, hasattr(d, "is_static"),
                "missing `is_static` attribute")
        for arg in ("x", "y", "round_i", "seed"):
            kw(d, "DRIFTS", name, "transform", arg)

    for name, factory in membership.CHURN_SCHEDULES.items():
        c = factory()
        methods(c, "CHURN_SCHEDULES", name, "live_mask")
        require(c, "CHURN_SCHEDULES", name, hasattr(c, "is_static"),
                "missing `is_static` attribute")

    return findings


# -- TL006: state-key consistency --------------------------------------------

#: state keys that are legitimately in-memory only: the round log is
#: re-derived (the checkpoint's meta persists the controller history)
EPHEMERAL_KEYS = frozenset({"log"})
#: per-participant (K, ...) slots that crash handling must reset and the
#: liveness freeze must carry per row
PER_SLOT_KEYS = frozenset({"params", "opt", "residual"})


def _state_keys(tree):
    """String keys accessed as state["…"] / state.get("…")."""
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "state"
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            keys.add(node.slice.value)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "state"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            keys.add(node.args[0].value)
    return keys


def _function_source_keys(tree, fn_name):
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == fn_name:
            return _state_keys(node)
    return None


def _class_state_keys(tree, class_names):
    """Keys accessed on the LEARNER state inside the named classes only:
    other ``state`` locals (an aggregator's round-state sub-dict) are a
    different namespace."""
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in class_names:
            keys |= _state_keys(node)
    return keys


def check_state_keys(threaded, io_keys, restart_keys, runner_keys,
                     io_path="src/repro_torch/checkpoint/io.py",
                     colearn_path="src/repro_torch/core/colearn.py"):
    """Pure core of TL006 (unit-tested on fabricated key sets).

    ``threaded``: keys the runners read/write on ``state``; ``io_keys``:
    keys the checkpoint's save/restore handles; ``restart_keys``: keys
    ``restart_participant`` resets; ``runner_keys``: keys the runners'
    live-row / finish-round plumbing touches."""
    findings = []
    for key in sorted(threaded - io_keys - EPHEMERAL_KEYS):
        findings.append(Finding(
            "TL006", io_path, 1,
            f"the runners thread state[{key!r}] but checkpoint save/"
            "restore never handles it: a resumed run silently drops it. "
            "Persist it (or add it to tracelint's EPHEMERAL_KEYS with a "
            "reason)."))
    for key in sorted((threaded & PER_SLOT_KEYS) - restart_keys):
        findings.append(Finding(
            "TL006", colearn_path, 1,
            f"per-participant state[{key!r}] is threaded but "
            "`restart_participant` does not reset it: a restarted slot "
            "would resume with stale per-slot memory."))
    for key in sorted((threaded & PER_SLOT_KEYS) - runner_keys):
        findings.append(Finding(
            "TL006", colearn_path, 1,
            f"per-participant state[{key!r}] is threaded but the round "
            "runners' select-live plumbing never touches it: dead slots "
            "would not carry it through a sync."))
    return findings


def check_project_state_keys():
    import inspect

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import api, colearn

    def tree_of(mod):
        path = inspect.getsourcefile(mod)
        with open(path) as fh:
            return path, ast.parse(fh.read(), filename=path)

    colearn_path, colearn_tree = tree_of(colearn)
    _, api_tree = tree_of(api)
    io_path, io_tree = tree_of(ckpt_io)

    runner_keys = _class_state_keys(api_tree,
                                    {"_PythonRunner", "_FusedRunner"})
    threaded = _state_keys(colearn_tree) | runner_keys
    io_keys = (_function_source_keys(io_tree, "save_round_state") or set()) \
        | (_function_source_keys(io_tree, "restore_round_state") or set())
    restart_keys = _function_source_keys(
        colearn_tree, "restart_participant") or set()
    return check_state_keys(threaded, io_keys, restart_keys, runner_keys,
                            io_path=io_path, colearn_path=colearn_path)


# -- entry points ------------------------------------------------------------

def run_paths(paths, baseline: str = DEFAULT_BASELINE,
              project_rules: bool = True):
    """All unsuppressed findings not covered by the baseline."""
    findings = []
    for path in iter_py_files(paths):
        findings.extend(lint_file(path))
    if project_rules:
        findings.extend(check_registries())
        findings.extend(check_project_state_keys())
    known = load_baseline(baseline) if baseline else set()
    return [f for f in findings if f.key() not in known]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracelint",
        description="static analysis of the traced-data discipline "
                    "(captured CUDA graphs)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--no-project-rules", action="store_true",
                    help="skip the import-based rules (TL005/TL006)")
    args = ap.parse_args(argv)
    findings = run_paths(args.paths, baseline=args.baseline,
                         project_rules=not args.no_project_rules)
    for f in findings:
        print(f.render())
    if findings:
        print(f"tracelint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"tracelint: clean ({', '.join(sorted(RULES))})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
