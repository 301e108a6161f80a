"""The shape helpers of ``repro_torch/launch/steps.py`` and the analytic
account of ``repro_torch/launch/analytic.py`` against the reference's, for
all ten architectures at their full published sizes.

The port builds every tree on the ``meta`` device (shapes and dtypes,
nothing allocated), where the reference uses ``jax.eval_shape``: the key
paths, shapes and dtypes of the params, the decode caches and every
``INPUT_SHAPES`` entry's input specs (with and without a leading
participant dim) are the reference's; ``param_counts`` is equal, and
``model_flops`` and ``scan_corrections`` for every shape and kind equal
the reference's floats at rel 1e-12.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch import analytic as janalytic
from repro.launch import steps as jsteps
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import steps as tsteps
from repro_torch.tree import leaves, leaves_with_path

KINDS = ("train", "prefill", "decode")
REL = 1e-12


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(v.shape), str(jnp.dtype(v.dtype)))
            for path, v in flat]


def _tflat(tree):
    out = []
    for path, t in leaves_with_path(tree):
        assert t.device.type == "meta", path
        out.append((path, tuple(t.shape), str(t.dtype).split(".")[-1]))
    return out


@functools.lru_cache(maxsize=None)
def _jparams(arch, dtype):
    return _jflat(jsteps.params_shapes(get_config(arch), dtype))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_shapes_match(arch, dtype):
    got = _tflat(tsteps.params_shapes(tget_config(arch),
                                      getattr(torch, dtype)))
    assert got == _jparams(arch, getattr(jnp, dtype))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shapes_match(arch):
    for dtype in ("bfloat16", "float32"):
        got = _tflat(tsteps.cache_shapes(tget_config(arch), 3, 40,
                                         getattr(torch, dtype)))
        want = _jflat(jsteps.cache_shapes(get_config(arch), 3, 40,
                                          getattr(jnp, dtype)))
        assert got == want, dtype


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_specs_match(arch, shape):
    """Each entry, bare and with a leading participant dim (as many as
    divide its global batch, up to 4), after ``config_for_shape``."""
    s = INPUT_SHAPES[shape]
    jcfg = jsteps.config_for_shape(get_config(arch), s)
    tcfg = tsteps.config_for_shape(tget_config(arch), s)
    for participants in (0, math.gcd(4, s.global_batch)):
        got = _tflat(tsteps.input_specs(tcfg, s, participants))
        want = _jflat(jsteps.input_specs(jcfg, s, participants))
        assert got == want, participants
        assert got


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_for_shape_matches(arch):
    for s in INPUT_SHAPES.values():
        j = jsteps.config_for_shape(get_config(arch), s)
        t = tsteps.config_for_shape(tget_config(arch), s)
        assert (t.window, t.name) == (j.window, j.name), s.name
    assert tsteps.LONG_WINDOW == jsteps.LONG_WINDOW
    assert tsteps.SWA_AT_500K == jsteps.SWA_AT_500K


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match(arch):
    got = tanalytic.param_counts(tget_config(arch))
    assert got == janalytic.param_counts(get_config(arch))
    assert got[0] >= got[1] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_scan_corrections_match(arch):
    """Every shape (after ``config_for_shape``) at every kind."""
    assert (tanalytic.CHUNK_Q, tanalytic.CHUNK_KV) == (janalytic.CHUNK_Q,
                                                       janalytic.CHUNK_KV)
    for s in INPUT_SHAPES.values():
        jcfg = jsteps.config_for_shape(get_config(arch), s)
        tcfg = tsteps.config_for_shape(tget_config(arch), s)
        for kind in KINDS:
            for fn in ("model_flops", "scan_corrections"):
                got = getattr(tanalytic, fn)(tcfg, s, kind)
                want = getattr(janalytic, fn)(jcfg, s, kind)
                assert got == pytest.approx(want, rel=REL, abs=0), \
                    (s.name, kind, fn)
                assert got >= 0


def test_meta_params_allocate_nothing():
    """The full-size deepseek-v3-671b tree (6.8e11 params) on ``meta``:
    every leaf there, no storage."""
    p = tsteps.params_shapes(tget_config("deepseek-v3-671b"))
    ts = leaves(p)
    assert all(t.is_meta for t in ts)
    assert sum(t.numel() for t in ts) > 6e11


def test_input_specs_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        tsteps.input_specs(tget_config("internlm2-1.8b"),
                           INPUT_SHAPES["long_500k"], participants=2)
