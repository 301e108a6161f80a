"""Explicit device choice: the port runs on the card unless asked not to."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises ``RuntimeError`` when CUDA is absent and
    the caller did not explicitly ask for the CPU — the port never falls
    back to the CPU on its own. ``meta`` (shapes and dtypes, no storage:
    the shape helpers of ``launch/steps.py`` and ``launch/analytic.py``)
    is accepted when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the port on the CPU explicitly")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         "'meta'")
    return dev


class MetaGenerator(torch.Generator):
    """A CPU generator that reports ``meta`` as its device.

    ``torch.Generator(device="meta")`` raises, while a factory given a CPU
    generator and ``device="meta"`` makes a meta tensor; the ``*_init``
    functions put their tensors on ``gen.device``, so this one makes them
    on ``meta`` and draws nothing."""

    @property
    def device(self):
        return torch.device("meta")
