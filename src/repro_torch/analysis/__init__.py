"""Static analysis and runtime guards of the traced-data discipline,
ported from ``repro/analysis``.

``tracelint`` is the AST pass (``python -m repro_torch.analysis.tracelint
src/repro_torch``); ``guards`` holds the runtime side: the capture count,
the ``no_retrace`` capture budget and the ``no_transfer`` sync guard that
the fused engine, ``ServeLoop``, the tests and ``chip_smoke.py`` share.
"""
from repro_torch.analysis.guards import (RetraceError, assert_compile_count,
                                         compile_count, no_retrace,
                                         no_transfer)

__all__ = ["RetraceError", "assert_compile_count", "compile_count",
           "no_retrace", "no_transfer"]
