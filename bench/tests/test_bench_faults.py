"""A run whose timed path is broken underneath comes out not correct:
each fault the cells can have, planted in the program at a tiny size on
the CPU (the harness's look for a card is skipped, the rest of a run is
driven as ``run.py`` drives it)."""
from __future__ import annotations

import pytest

from bench.tests import tiny


def _state_unchanged(mp):
    from repro_torch.core.colearn import CoLearner
    from repro_torch.tree import leaves
    orig = CoLearner.run_round

    def frozen(self, state, fn, on_round_end=None):
        keep = [t.clone() for t in leaves(state["params"])]
        state = orig(self, state, fn, on_round_end)
        for t, k in zip(leaves(state["params"]), keep):
            t.copy_(k)
        return state
    mp.setattr(CoLearner, "run_round", frozen)


def _half_batch(mp):
    from repro_torch.launch import train
    orig = train.make_loss_fn

    def make(cfg, remat=True):
        fn = orig(cfg, remat)

        def loss(params, batch):
            x, y = batch
            return fn(params, (x[:x.shape[0] // 2], y[:y.shape[0] // 2]))
        return loss
    mp.setattr(train, "make_loss_fn", make)


def _no_exchange(mp):
    from repro_torch.core import api
    mp.setattr(api.FlatFusedIntN, "make_fused_mean",
               lambda self, **kw: (lambda stacked, live=None: stacked))


def _answer_altered(mp):
    from repro_torch.launch import steps
    orig = steps.make_prefill_step

    def make(cfg, impl="ref"):
        step = orig(cfg, impl)

        def altered(params, batch):
            out = step(params, batch)
            out[0, 0] += 1.0
            return out
        return altered
    mp.setattr(steps, "make_prefill_step", make)


def _token_altered(mp):
    from repro_torch.serving.loop import ServeLoop
    orig = ServeLoop.generate

    def generate(self, prompts, new_tokens):
        gen, stats = orig(self, prompts, new_tokens)
        gen[0, -1] = (gen[0, -1] + 1) % self.cfg.vocab_size
        return gen, stats
    mp.setattr(ServeLoop, "generate", generate)


@pytest.mark.parametrize("entry,model,fault", [
    ("round", tiny.DENSE, _state_unchanged),
    ("round", tiny.DENSE, _half_batch),
    ("round", tiny.DENSE, _no_exchange),
    ("prefill", tiny.HYBRID, _answer_altered),
    ("decode", tiny.DENSE, _token_altered)],
    ids=["state_unchanged", "half_batch", "no_exchange", "answer_altered",
         "token_altered"])
def test_fault_is_not_correct(entry, model, fault, monkeypatch):
    fault(monkeypatch)
    res, _ = tiny.run(entry, model, seed=2**31 + 17)
    assert not res["correct"], res["checks"]
