"""Entry ``prefill``: ``launch/steps.make_prefill_step(cfg, impl)``, the
full-sequence forward with the LM head on the last position
(``impl="kernel"``: attention through K5, the Mamba scan through K6).

Traffic parameters: ``batch``, ``seq_len``, ``impl``, ``checked_calls``,
``traced_calls``. A closed loop: each call is a new batch of uniform
token ids drawn on the device from the seed and the call's index.

The check draws ``checked_calls`` of the window's calls from the seed and
runs the plain reference over their prompts, on the same weights (the
benchmark's, which a prefill only reads), once the window has closed:
the widest gap of a last-position logit from the reference's, over the
reference logits' RMS.
"""
from __future__ import annotations

import random

import torch

from bench import weights
from bench.harness import free_device, model_config

_STREAM = 2_000_003


def prompt_tokens(seed, call, t, vocab, device):
    return weights.tokens(seed, _STREAM, call, (t["batch"], t["seq_len"]),
                          vocab, device)


def logit_gap(prog, ref):
    """max |prog - ref| over the reference logits' RMS."""
    return float((prog - ref).abs().max() / ref.pow(2).mean().sqrt())


class Driver:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.vocab = run.config["model"]["vocab_size"]
        self.traced_calls = self.t["traced_calls"]
        self.answers = {}

    def attempted(self, calls):
        return calls

    def setup(self):
        from repro_torch.launch.steps import make_prefill_step
        run = self.run
        self.cfg = model_config(run.config)
        self.table = weights.shapes(self.cfg)
        self.params = weights.make(run.ref, self.table, run.seed,
                                   run.device)
        self.step = make_prefill_step(self.cfg, impl=self.t["impl"])
        self.call(-1)                   # this cell's one shape, warmed
        self.answers.clear()

    def call(self, i):
        toks = prompt_tokens(self.run.seed, i, self.t, self.vocab,
                             self.run.device)
        self.answers[i] = self.step(self.params, {"tokens": toks})
        return toks.numel()

    def release(self):
        del self.step
        free_device()

    def sample(self):
        """The checked calls, drawn from the seed among the window's."""
        calls = list(range(self.window_calls))
        rng = random.Random(self.run.seed)
        return sorted(rng.sample(calls, min(self.t["checked_calls"],
                                            len(calls))))

    def reference_logits(self, i, low=False):
        toks = prompt_tokens(self.run.seed, i, self.t, self.vocab,
                             self.run.device)
        with torch.no_grad():
            return self.run.ref.logits(self.params, self.run.config["model"],
                                       toks, low=low, last_only=True)

    def check(self):
        worst = 0.0
        for i in self.sample():
            worst = max(worst, logit_gap(self.answers[i],
                                         self.reference_logits(i)))
        del self.params
        free_device()
        return {"logit_gap": worst}
