"""``repro_torch/sharding/specs.py`` against ``repro/sharding/specs.py``:
the same partition specs, entry for entry, for every architecture's
params (plain and participant-stacked), batches and decode caches, on a
(2, 2, 2) ``pod x data x model`` mesh (the reference's
``jax.sharding.AbstractMesh``, the port's mapping of sizes)."""
import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCH_IDS, get_config
from repro.launch import steps as jsteps
from repro.sharding import specs as jspecs
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.sharding import specs as tspecs

SHAPE = (2, 2, 2)
AXES = ("pod", "data", "model")


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), v) for path, v in flat]


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) \
            else tree[key]
    return tree


def _assert_same(jtree, ttree):
    pairs = _flat(jtree)
    assert pairs
    for path, spec in pairs:
        assert tuple(spec) == _at(ttree, path), path


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    return jsteps.params_shapes(get_config(arch), jnp.float32)


@pytest.fixture(scope="module")
def meshes():
    return AbstractMesh(SHAPE, AXES), dict(zip(AXES, SHAPE))


def test_the_archs_are_the_references():
    assert T_ARCH_IDS == ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("participant", [False, True])
def test_param_specs_match_the_reference(meshes, arch, participant):
    jmesh, tmesh = meshes
    shapes = _shapes(arch)
    if participant:
        shapes = jax.tree.map(
            lambda v: jax.ShapeDtypeStruct((2, *v.shape), v.dtype), shapes)
    cfg = get_config(arch)
    _assert_same(jspecs.param_specs(shapes, cfg, jmesh, participant),
                 tspecs.param_specs(shapes, tget_config(arch), tmesh,
                                    participant))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_the_reference(meshes, arch):
    jmesh, tmesh = meshes
    cfg, tcfg = get_config(arch), tget_config(arch)
    for kind in ("train", "decode"):
        for participant in (False, True):
            _assert_same(jspecs.batch_specs(cfg, jmesh, kind, participant),
                         tspecs.batch_specs(tcfg, tmesh, kind, participant))
    for batch in (8, 1):
        cache = jsteps.cache_shapes(cfg, batch, 64, jnp.float32)
        _assert_same(jspecs.cache_specs(cache, jmesh, batch),
                     tspecs.cache_specs(cache, tmesh, batch))
