"""The frozen counts agree with the port's own (``launch/analytic.py``,
``core/flatbuf.py``) on the day they were frozen."""
from __future__ import annotations

import json

import pytest
import torch

from bench import counts
from bench.harness import model_config
from bench.tests import tiny

CONFIGS = ["internlm2-1.8b", "internlm2-1.8b-serve", "jamba-v0.1-52b"]


def _arch(name):
    return json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())


def _models():
    return ([_arch(c)["model"] for c in CONFIGS]
            + [tiny.DENSE, tiny.HYBRID])


@pytest.mark.parametrize("model", _models(), ids=lambda m: m["name"])
def test_param_counts_match_the_port(model):
    from repro_torch.launch import analytic
    cfg = model_config({"model": model})
    assert counts.param_counts(model) == analytic.param_counts(cfg)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("model", _models(), ids=lambda m: m["name"])
def test_model_flops_match_the_port(model, kind):
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import analytic
    cfg = model_config({"model": model})
    shape = InputShape("x", 256, 8, kind)
    assert counts.model_flops(model, 8, 256, kind) == pytest.approx(
        analytic.model_flops(cfg, shape, kind), rel=1e-12)


@pytest.mark.parametrize("model", _models(), ids=lambda m: m["name"])
def test_wire_layout_matches_the_port(model):
    from repro_torch.core import flatbuf
    from repro_torch.core.averaging import stack_participants
    from repro_torch.launch.steps import params_shapes
    cfg = model_config({"model": model})
    stacked = stack_participants(params_shapes(cfg, torch.float32), 5)
    layout = flatbuf.make_layout(stacked)
    assert counts.wire_n_pad(model) == layout.n_pad
    assert sum(counts.leaf_sizes(model)) == sum(layout.sizes)


def test_kernel_counts_by_hand():
    # one row, one head, S = 2: 3 causal pairs, each 2 products of hd
    assert counts.k5(1, 2, 1, 1, 4) == (4 * 3 * 4, 4 * 2 * 4 * 4)
    ops, nbytes = counts.k6(1, 1, 1, 1)
    assert (ops, nbytes) == (8 + 2, 4 * (3 + 2 + 1 + 1 + 1))
    assert counts.k3(tiny.DENSE, 3)[1] == 4 * 4 * counts.wire_n_pad(
        tiny.DENSE)
