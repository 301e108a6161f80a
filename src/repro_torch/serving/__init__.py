"""Serving, ported from ``repro/serving``: ``ModelBank`` versions each
round's shared model (or the stacked ensemble) with staleness metadata;
``ServeLoop`` is the batched KV-cache decode loop that polls the bank and
hot-swaps params between batches. The continuous train-and-serve loop
(``launch/continuous.py``) is still to port (ROADMAP.md).
"""
from repro_torch.serving.bank import MODES, ModelBank, ModelSnapshot
from repro_torch.serving.loop import ServeLoop, serve_rounds_stats

__all__ = ["MODES", "ModelBank", "ModelSnapshot", "ServeLoop",
           "serve_rounds_stats"]
