"""Program spans: named ranges at the port's layer boundaries, on the
kernel trace's clock.

Tracing is off by default and free when off: :func:`span` tests one
module-level bool and returns a shared no-op context manager, so nothing
is annotated, recorded or allocated. :func:`enable` / :func:`disable` turn
it on and off. When it is on, a span is
``torch.profiler.record_function(name)``: under a profiler, kineto puts
the range on the clock of the kernels it launched and mirrors it on the
device's timeline, so the device time under a span is read off the trace
(a reader that sums device time leaves the ``rt.*`` mirrors out: they are
annotations, not work).

Every name the program emits starts with ``rt.``:

================== ===================================================
``rt.round.*``     ``core/api.py`` ``_FusedRunner.run_round``'s host
                   phases: ``stage``, ``replay``, ``fetch``, ``finish``
``rt.prefill``     ``models/transformer.py`` ``prefill``
``rt.embed``       the input embedding
``rt.mixer.*``     a layer's norm, mixer and residual: ``attention``,
                   ``mla``, ``mamba``, ``mlstm``, ``slstm``
``rt.ffn.*``       a layer's FFN half: ``dense``, ``moe``, ``moe_dense``
``rt.moe.*``       inside ``models/moe.py`` ``moe_apply``: ``route``
                   (router and dispatch), ``experts``, ``combine``
``rt.head``        the LM head
``rt.serve.*``     ``serving/loop.py`` ``ServeLoop``: ``prefill``,
                   ``decode``, and ``step`` around each replay
================== ===================================================

Two device clocks work beside the spans, both read only while tracing is
on: :func:`marks` makes timing events with ``external=True``, which,
recorded inside a CUDA graph capture, become nodes of the graph, so
every replay records them (the fused round's epochs / finalize split,
``RoundLog.epochs_ms`` / ``finalize_ms``); :func:`stamp` records one
event now (``ServeLoop.generate``'s ``step_ms``, the pod path's split).
A graph is captured once, whether tracing is on or not, so the marks a
capture takes are in the graph for its life.
"""
from __future__ import annotations

import contextlib

import torch

_on = False
_OFF = contextlib.nullcontext()


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled():
    return _on


def span(name):
    """A context manager naming the range it encloses
    (``record_function``); a shared no-op while tracing is off."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


def marks(device, n=3):
    """``n`` timing events for a captured graph (``external=True``:
    recorded during a capture, each becomes a node of the graph), or None
    off the card. Record them with :func:`record`."""
    if torch.device(device).type != "cuda":
        return None
    return [torch.cuda.Event(enable_timing=True, external=True)
            for _ in range(n)]


def record(marks, i):
    """Record ``marks[i]`` on the current stream (no-op without marks)."""
    if marks is not None:
        marks[i].record()


def between(marks):
    """Device ms between consecutive ``marks`` once their last record has
    completed, or None (tracing off, or no marks)."""
    if not _on or marks is None:
        return None
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def stamp(device):
    """A timing event recorded now on ``device``'s current stream while
    tracing is on, on a card, outside a capture (an event recorded there
    times nothing); else None."""
    dev = torch.device(device)
    if (not _on or dev.type != "cuda"
            or torch.cuda.is_current_stream_capturing()):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev
