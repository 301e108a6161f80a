"""The small helpers the reference's own tests use, against the JAX
package: ``quantize.packed_width``, ``layers.dense_apply``,
``averaging.average_mean`` and ``compression.quantize_roundtrip`` /
``make_compress_fn``. Inputs from numpy with a fixed seed, f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import averaging as javg
from repro.core import compression as jcomp
from repro.kernels import quantize as jqz
from repro.models import layers as jlayers
from repro_torch.core import averaging as tavg
from repro_torch.core import compression as tcomp
from repro_torch.kernels import quantize as tqz
from repro_torch.models import layers as tlayers


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_packed_width_matches(bits):
    assert tqz.packed_width(256, bits) == jqz.packed_width(256, bits)


@pytest.mark.parametrize("bias", [False, True])
def test_dense_apply_matches(bias):
    p = {"w": _x((6, 5), 1)}
    if bias:
        p["b"] = _x((5,), 2)
    x = _x((2, 3, 6), 3)
    np.testing.assert_allclose(
        tlayers.dense_apply({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x)).numpy(),
        np.asarray(jlayers.dense_apply(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_average_mean_matches():
    tree = {"a": _x((3, 4, 5), 4), "b": [_x((3, 7), 5)]}
    got = tavg.average_mean({"a": torch.tensor(tree["a"]),
                             "b": [torch.tensor(tree["b"][0])]})
    want = javg.average_mean({"a": jnp.asarray(tree["a"]),
                              "b": [jnp.asarray(tree["b"][0])]})
    for g, w in ((got["a"], want["a"]), (got["b"][0], want["b"][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7,
                                   atol=1e-7)


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_quantize_roundtrip_and_compress_fn_match(bits):
    """Against the reference's plain (``impl="ref"``) roundtrip: a leaf
    over one block, a ragged one and one below a block (passed through
    unchanged). Bit for bit at 8 and 4 bits; at 1 bit the scale is a
    mean of |x| whose summation order differs, held at the wire's 1-bit
    tolerance (rtol = atol = 2e-6, as the kernels')."""
    tree = {"big": _x((3, 300), 6), "odd": _x((2, 5, 77), 7),
            "small": _x((3, 10), 8)}
    t_tree = {k: torch.tensor(v) for k, v in tree.items()}
    j_tree = {k: jnp.asarray(v) for k, v in tree.items()}
    want = jcomp.quantize_roundtrip(j_tree, bits=bits)
    for got in (tcomp.quantize_roundtrip(t_tree, bits=bits),
                tcomp.make_compress_fn(bits=bits)(t_tree)):
        tol = 2e-6 if bits == 1 else 0.0
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=tol, atol=tol)
    assert got["small"] is t_tree["small"]
