"""PyTorch/CUDA port of the co-learning system (Algorithm 1 on one card).

The package mirrors ``repro`` file for file: ``repro_torch/core/flatbuf.py``
ports ``repro/core/flatbuf.py`` and so on. It imports ``torch`` and
``numpy`` only; the numpy-only modules it needs (configs, data) are kept
here as copies. Parameters are nested dicts of tensors with the same keys
and nesting as the JAX tree, flattened in JAX's order (``tree.py``), so
the flat wire buffer is element for element the JAX one.

Every entry point takes ``device=`` and runs on the card unless the
caller passes ``"cpu"`` (``device.resolve_device``). On a CUDA tensor the
wire kernels launch their hand-written Hopper kernels
(``kernels/csrc/wire.cu``); the plain PyTorch versions in
``kernels/ref.py`` serve CPU tensors only.
"""
