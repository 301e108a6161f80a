"""The plain references agree with the port at a tiny size on the CPU:
each entry's whole run (set-up, window, check) comes out correct, and the
benchmark's weights fill the port's tree exactly."""
from __future__ import annotations

import pytest
import torch

from bench import weights
from bench.harness import model_config
from bench.tests import tiny


@pytest.mark.parametrize("entry,model", [
    ("round", tiny.DENSE), ("round", tiny.HYBRID),
    ("prefill", tiny.DENSE), ("prefill", tiny.HYBRID),
    ("decode", tiny.DENSE), ("decode", tiny.HYBRID)],
    ids=lambda x: x if isinstance(x, str) else x["name"])
def test_entry_matches_reference(entry, model):
    torch.manual_seed(0)
    res, _ = tiny.run(entry, model, seed=2**31 + 5)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.HYBRID],
                         ids=lambda m: m["name"])
def test_weights_fill_the_port_tree(model):
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves_with_path
    from bench.reference import transformer as ref
    cfg = model_config({"model": model})
    table = weights.shapes(cfg)
    made = weights.make(ref, table, 11, "cpu")
    port = tr.init_params(0, cfg, torch.float32, device="cpu")
    got = [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_path(made)]
    want = [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_path(port)]
    assert got == want
    again = weights.make(ref, table, 11, "cpu")
    for (_, a), (_, b) in zip(leaves_with_path(made),
                              leaves_with_path(again)):
        assert torch.equal(a, b)


def test_seeds_give_other_weights():
    from bench.reference import transformer as ref
    table = weights.shapes(model_config({"model": tiny.DENSE}))
    a = weights.make(ref, table, 2**31 + 1, "cpu")
    b = weights.make(ref, table, 2**31 + 2, "cpu")
    assert not torch.equal(a["embed"]["table"], b["embed"]["table"])
