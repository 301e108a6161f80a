"""Serving, ported from ``repro/serving``: ``ModelBank`` versions each
round's shared model (or the stacked ensemble) with staleness metadata;
``ServeLoop`` is the batched KV-cache decode loop that polls the bank and
hot-swaps params between batches; ``launch/continuous.py`` closes the
train-and-serve loop over a drifting ``data/stream.ShardStream``.
"""
from repro_torch.serving.bank import MODES, ModelBank, ModelSnapshot
from repro_torch.serving.loop import ServeLoop, serve_rounds_stats

__all__ = ["MODES", "ModelBank", "ModelSnapshot", "ServeLoop",
           "serve_rounds_stats"]
