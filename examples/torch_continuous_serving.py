"""Continuous operation: train on a drifting stream, serve between rounds,
on the PyTorch port (``repro_torch``).

The paper's data centers keep *producing* data while training runs — and
keep *serving* the model they train. This walkthrough closes that loop at
CPU scale with the three pieces of ``repro_torch.serving`` and
``repro_torch.data.stream``:

1. A ``ShardStream`` stages each round's shards from a drifting corpus
   (here an abrupt task switch at round 3 — labels are cyclically
   remapped, the classic concept-drift recovery scenario). Shapes are a
   round-0 invariant, so the drifting contents are copied into the static
   inputs of the one captured round graph.
2. A ``ModelBank`` versions the shared model after every synced round
   (``CoLearner.run_round``'s ``on_round_end`` hook, which only reads the
   learner's tensors). Quiet rounds under the divergence-triggered sync
   policy publish nothing — the bank keeps serving the last *synced*
   model, stale but still the shared one.
3. A ``ServeLoop`` polls the bank between rounds and hot-swaps the newest
   version into its single captured decode step: same tree and shapes
   mean the swap copies into the loop's own params — the decode capture
   count stays 1 across every swap (asserted at the end).

Run:  PYTHONPATH=src python examples/torch_continuous_serving.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core.api import DivergenceTrigger
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.data.stream import AbruptDrift, ShardStream
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.serving import ModelBank, ServeLoop

K, ROUNDS = 3, 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_smoke_config("internlm2-1.8b").with_(  # 1-layer reduced model
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, segments=((("gqa:dense",), 1),))

    # the stream: same corpus surface as ParticipantData, but round-indexed
    # — at round 3 the label space is cyclically remapped (the task switch)
    x, y = lm_examples(seed=0, n=240, seq_len=16, vocab=cfg.vocab_size)
    stream = ShardStream([x, y], K, batch_size=8, seed=0,
                         drift=AbruptDrift(at_round=3))

    learner = CoLearner(
        CoLearnConfig(n_participants=K, T0=2, eta0=0.05, epsilon=0.05,
                      max_rounds=ROUNDS),
        loss_fn=lambda p, b: tr.loss_fn(p, cfg, {"tokens": b[0],
                                                 "labels": b[1]}),
        round_engine="fused",
        sync_policy=DivergenceTrigger(delta=0.02),  # quiet while locals agree
        device=dev,
    )
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))

    # publication + serving: v1 is the init model, so serving is live from
    # round 0 even if the first rounds stay quiet; the loop takes over the
    # params it is built with, so it gets its own copy
    bank = ModelBank()
    bank.publish(learner.shared_model(state), round_i=0)
    serve = ServeLoop(cfg, learner.shared_model(state), batch=4, max_seq=16,
                      device=dev)
    serve.poll(bank)
    prompts = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 6)), device=dev)

    for _ in range(ROUNDS):
        state = learner.run_round(
            state,
            lambda i_, j_: tuple(stage(a, device=dev)
                                 for a in stream.epoch_batches(i_, j_)),
            on_round_end=bank.publish_from)      # synced rounds publish
        swapped = serve.poll(bank)               # quiet rounds: no swap
        _, stats = serve.generate(prompts, new_tokens=8)
        log = state["log"][-1]
        print(f"round {log.round}: {'sync' if log.synced else 'quiet'} "
              f"loss={np.mean(log.local_losses):.3f} "
              f"serving v{serve.version} "
              f"(stale {bank.staleness(state['round'])} rounds) "
              f"{'swapped' if swapped else 'held'} "
              f"{stats['tokens_per_s']:.0f} tok/s "
              f"compiles={stats['compile_count']}")

    assert serve.compile_count() == 1, "a hot swap must never recapture decode"
    print(f"served {serve.tokens_served} tokens across {serve.batches_served} "
          f"batches while training {ROUNDS} rounds; final version "
          f"v{serve.version} of {bank.version}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
