"""Entry ``decode``: ``serving/loop.ServeLoop.generate``, greedy decode of
a static batch whose decode step is captured once as a CUDA graph and
replayed for every prompt and decode token.

Traffic parameters: ``batch``, ``prompt``, ``new``, ``max_seq``,
``checked_requests``, ``traced_calls``. A closed loop of one client: each
call is a new batch of ``batch`` prompts of uniform token ids, drawn on
the device from the seed and the call's index; a request is one row.

The check draws ``checked_requests`` requests of the window's calls from
the seed and runs the plain reference once over each prompt with its
served tokens: the widest gap by which a served token's logit lies below
the reference's best at its position.
"""
from __future__ import annotations

import random

import torch

from bench import weights
from bench.harness import free_device, model_config

_STREAM = 3_000_003


def prompts(seed, call, t, vocab, device):
    return weights.tokens(seed, _STREAM, call, (t["batch"], t["prompt"]),
                          vocab, device)


def served_gaps(ref_logits, served, prompt_len):
    """(B, new) gaps: the reference's best logit at each served position
    less the served token's. ``ref_logits`` (B, S, V) over prompt + served
    tokens; the token at position p was chosen from position p - 1."""
    lg = ref_logits[:, prompt_len - 1:-1]
    return lg.max(-1).values - lg.gather(-1, served[..., None])[..., 0]


class Driver:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.vocab = run.config["model"]["vocab_size"]
        self.traced_calls = self.t["traced_calls"]
        self.served = {}

    def attempted(self, calls):
        return calls * self.t["batch"]

    def setup(self):
        from repro_torch.serving.loop import ServeLoop
        run = self.run
        self.cfg = model_config(run.config)
        self.table = weights.shapes(self.cfg)
        self.params = weights.make(run.ref, self.table, run.seed,
                                   run.device)
        self.loop = ServeLoop(self.cfg, self.params, batch=self.t["batch"],
                              max_seq=self.t["max_seq"], device=run.device)
        # the prompt steps and one decode step replay the one captured
        # step and run every op of a call: the cell's shapes, warmed
        self.loop.generate(prompts(run.seed, -1, self.t, self.vocab,
                                   run.device), 1)

    def call(self, i):
        p = prompts(self.run.seed, i, self.t, self.vocab, self.run.device)
        gen, _ = self.loop.generate(p, self.t["new"])
        self.served[i] = gen
        return gen.numel()

    def release(self):
        self.run.counters["replays_per_call"] = (
            self.t["prompt"] + self.t["new"])
        del self.loop
        free_device()

    def sample(self):
        """(call, row) of the checked requests, drawn from the seed among
        the window's."""
        rows = [(i, b) for i in range(self.window_calls)
                for b in range(self.t["batch"])]
        rng = random.Random(self.run.seed)
        return sorted(rng.sample(rows, min(self.t["checked_requests"],
                                           len(rows))))

    def reference_gaps(self, picks, low=False):
        """Per request: the f32 reference's logits over its prompt and
        served tokens, and the tokens judged: the served ones, or with
        ``low`` the ones the lower precision puts first."""
        out = []
        for i, b in picks:
            prompt = prompts(self.run.seed, i, self.t, self.vocab,
                             self.run.device)[b:b + 1]
            served = self.served[i][b:b + 1]
            seq = torch.cat([prompt, served], 1)
            with torch.no_grad():
                ref = self.run.ref.logits(self.params,
                                          self.run.config["model"], seq)
                judged = served
                if low:
                    lowl = self.run.ref.logits(
                        self.params, self.run.config["model"], seq, low=True)
                    judged = lowl[:, self.t["prompt"] - 1:-1].argmax(-1)
                out.append(served_gaps(ref, judged, self.t["prompt"]))
        return torch.cat(out)

    def check(self):
        gaps = self.reference_gaps(self.sample())
        del self.params
        free_device()
        return {"served_gap": float(gaps.max())}
