"""The port's flat-buffer layout, buffer and byte accounting against the
JAX package, on the smoke transformer's stacked tree (K=3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import api as japi
from repro.core import averaging as javg
from repro.core import compression as jcomp
from repro.core import flatbuf as jfb
from repro.models import transformer as jtr
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core import api as tapi
from repro_torch.core import compression as tcomp
from repro_torch.core import flatbuf as tfb
from repro_torch.tree import leaves

K = 3


@pytest.fixture(scope="module")
def stacked():
    cfg = get_smoke_config("internlm2-1.8b")
    p = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    # distinct participants, so a slot mix-up cannot pass
    js = jax.tree.map(
        lambda t: jnp.asarray(np.asarray(t)[None] + rng.standard_normal(
            (K, *t.shape)).astype(np.float32) * 0.01),
        javg.stack_participants(p, 1))
    ts = params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    return js, ts


def test_layout_equals_jax(stacked):
    js, ts = stacked
    jl, tl = jfb.make_layout(js), tfb.make_layout(ts)
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert (tl.n, tl.n_pad, tl.k) == (jl.n, jl.n_pad, jl.k)
    assert tl.shapes == jl.shapes


def test_flatten_bit_exact_and_roundtrip(stacked):
    js, ts = stacked
    jl, tl = jfb.make_layout(js), tfb.make_layout(ts)
    tbuf = tfb.flatten(ts, tl)
    np.testing.assert_array_equal(tbuf.numpy(),
                                  np.asarray(jfb.flatten(js, jl)))
    back = tfb.unflatten(tbuf, tl)
    for a, b in zip(leaves(back), leaves(ts)):
        assert torch.equal(a, b)
    # the mean lands in every slot, in place
    mean = tbuf.mean(0)
    out = tfb.unflatten(tbuf, tl)
    assert tfb.unflatten_mean(mean, tl, out=out) is out
    want = jfb.unflatten_mean(jnp.asarray(mean.numpy()), jl)
    for a, b in zip(leaves(out), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_byte_counts_equal_jax(stacked, bits):
    js, ts = stacked
    assert tfb.wire_bytes(tfb.make_layout(ts), bits=bits) == \
        jfb.wire_bytes(jfb.make_layout(js), bits=bits)
    assert tcomp.flat_compressed_bytes(ts, bits=bits) == \
        jcomp.flat_compressed_bytes(js, bits=bits)
    one_t = jax.tree.map(lambda t: t[0], js)
    assert tcomp.compressed_bytes({"a": ts["embed"]["table"][0],
                                   "b": torch.zeros(7)}, bits=bits) == \
        jcomp.compressed_bytes({"a": one_t["embed"]["table"],
                                "b": jnp.zeros(7)}, bits=bits)
    for name in ("exact", "leafwise", "fused"):
        kw = {} if name == "exact" else {"bits": bits}
        assert tapi.get_codec(name, **kw).wire_bytes(ts) == \
            japi.get_codec(name, **kw).wire_bytes(js)
