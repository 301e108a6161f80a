"""Runtime guards of the traced-data discipline, ported from
``repro/analysis/guards.py``.

Per-round quantities ride into long-lived captured CUDA graphs
(``core/graphs.py``) as data in static buffers: nothing recaptures per
round and no implicit host<->device synchronisation lands on the round's
critical path. ``tracelint`` enforces the static half; this module is
the runtime half and the one place the port reads a capture count:

* :func:`compile_count` / :func:`assert_compile_count`: the captures
  behind a ``Captured``, a ``GraphSet``, an owner of one (a
  ``ServeLoop``, a fused round step, a round runner: its ``graphs``) or
  a :class:`no_retrace` wrapper. ``ServeLoop.compile_count`` counts
  through it.
* :class:`no_retrace`: wraps a captured callable and raises
  :class:`RetraceError` at the call that would hold more graphs than
  promised, before it captures. A recapture is otherwise silent (a
  capture's seconds, a second graph's pool).
* :func:`no_transfer`: on a CUDA device, runs its block under
  ``torch.cuda.set_sync_debug_mode("error")`` (any host synchronisation
  raises: ``.item()``, ``.cpu()``, ``float()`` of a card tensor, a
  pageable copy) and restores the previous mode. The reference's
  ``jax.transfer_guard("disallow")`` lets explicit staging through; the
  port stages through pinned memory with ``non_blocking`` copies
  (``engine.stage``), which do not synchronise, and lifts the guard
  where a synchronisation is meant (``core/graphs.allow_sync``).
  ``GraphSet.no_sync()``, the fused engine's round window, is this guard.
"""
from __future__ import annotations

import contextlib

import torch


class RetraceError(RuntimeError):
    """A guarded function captured (or would capture) more graphs than
    promised. ``core/graphs.RecaptureError`` is one."""


def compile_count(fn) -> int:
    """Captured graphs behind ``fn``: a ``Captured`` or a ``GraphSet``
    (their ``captures``), an object holding a ``GraphSet`` as ``graphs``,
    or a :class:`no_retrace` wrapper. Zero until the first call."""
    if isinstance(fn, no_retrace):
        return fn.compile_count()
    if hasattr(fn, "captures"):
        return int(fn.captures)
    graphs = getattr(fn, "graphs", None)
    if graphs is not None and hasattr(graphs, "captures"):
        return int(graphs.captures)
    raise TypeError(f"{type(fn).__name__} holds no captured graphs")


def assert_compile_count(fn, expected: int,
                         what: str = "captured function"):
    """Assert ``fn`` captured exactly ``expected`` graphs: the
    after-the-fact form of :class:`no_retrace`, for graphs built
    elsewhere (the fused engine's round, epochs and finalize)."""
    n = compile_count(fn)
    if n != expected:
        raise RetraceError(
            f"{what}: compile count {n} != expected {expected} — a "
            "per-round quantity leaked into the capture (a python scalar "
            "baked into the graph, python branching on data, or a "
            "shape/dtype/storage drift across calls)")
    return n


class no_retrace:
    """Wrap a captured callable (a ``core/graphs.Captured``) so that every
    call keeps a capture budget.

    >>> step = no_retrace(graphs.capture(f, "step"), limit=1, what="step")
    >>> step(x)            # captures once: count 1 <= limit, fine
    >>> step(x.double())   # RetraceError, raised before capturing

    ``limit`` is the number of graphs the wrapper tolerates (1 for the
    single-layout functions the port captures). A call that would capture
    past it raises before capturing, so the graphs held stay as they
    were; ``compile_count()`` reads the wrapped function's captures."""

    def __init__(self, captured, *, limit: int = 1,
                 what: str = "captured function"):
        self._fn = captured
        self.limit = int(limit)
        self.what = what

    def __call__(self, *args, **kwargs):
        would = getattr(self._fn, "would_capture", None)
        if would is not None and would(*args):
            self.check(count=self.compile_count() + 1)
        out = self._fn(*args, **kwargs)
        self.check()
        return out

    def compile_count(self) -> int:
        return compile_count(self._fn)

    def check(self, limit: int | None = None, count: int | None = None):
        """Raise :class:`RetraceError` if the budget is exceeded (by the
        graphs held, or by ``count``)."""
        n = self.compile_count() if count is None else count
        lim = self.limit if limit is None else int(limit)
        if n > lim:
            raise RetraceError(
                f"{self.what}: {n} captured graphs exceed the no_retrace "
                f"limit of {lim} — an argument changed its layout or its "
                "storage, or a per-call quantity was baked into the graph "
                "instead of riding in as data")
        return n


@contextlib.contextmanager
def no_transfer(device):
    """Make every host synchronisation inside the block raise, on a CUDA
    ``device``: ``torch.cuda.set_sync_debug_mode("error")``, the previous
    mode restored after. On the CPU it does nothing: there is no
    host<->device boundary to guard there, so a CPU run shows nothing
    about transfers."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
