"""``sharding/constrain.py`` against ``repro/sharding/constrain.py``: the
resolution rule of a spec entry (absent axes dropped, leading axes
dropped until the product divides the dim, "r" replicated, "dp" the batch
axes) over a grid of dims, markers and mesh sizes; a plain tensor passes
through ``constrain`` and ``local_call`` untouched."""
import itertools
from contextlib import nullcontext

import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.sharding import constrain as jc
from repro_torch.sharding import constrain as tc

MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"pod": 3, "data": 4, "model": 1}, {"model": 8}]
MARKERS = ["r", "dp", "data", "model", "pod", "expert", ("pod", "data"),
           ("data", "model"), ("pod", "data", "model"), ("expert", "model")]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 256, 4096]


class _Mesh:
    """What the reference's rule reads of a mesh: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref(dim, ax, sizes):
    entry, pinned = jc._resolve(dim, ax, _Mesh(sizes), set(sizes))
    return (tc.U if entry is P.UNCONSTRAINED else entry), pinned


@pytest.mark.parametrize("sizes", MESHES,
                         ids=["x".join(map(str, m.values())) for m in MESHES])
@pytest.mark.parametrize("dp", [None, ("data",)], ids=["dp-default",
                                                        "dp-data"])
def test_resolve_equals_the_reference(sizes, dp):
    with (tc.batch_axes(dp) if dp else nullcontext()), \
            (jc.batch_axes(dp) if dp else nullcontext()):
        for dim, ax in itertools.product(DIMS, MARKERS):
            got = tc._resolve(dim, ax, _Mesh(sizes), set(sizes))
            assert got == _ref(dim, ax, sizes), (dim, ax)


def test_plain_tensors_pass_through():
    x = torch.randn(4, 6)
    assert tc.constrain(x, ("dp", "model")) is x
    assert tc.index_copy_(torch.zeros(2, 3), 0, torch.tensor([1]),
                          torch.ones(1, 3))[1].sum() == 3
    out = tc.local_call(lambda a, b: a + b, (x, x), (("dp", None),) * 2,
                        ("dp", None))
    assert torch.equal(out, 2 * x)
    assert not tc.on_mesh({"a": x}) and tc.dp_size(x) == 1
    assert tc.axis_size(x, "model") == 1
