"""Scenario: batched KV-cache serving of a co-learned model, on the
PyTorch port (``repro_torch``).

Trains a reduced Jamba (hybrid Mamba+attention+MoE) with co-learning for a
couple of rounds, then serves batched greedy decoding from the shared
model through a ``ServeLoop``: its one decode step (the torch form of the
reference's jitted ``decode_step``) is captured once as a CUDA graph on
the card and replayed for every prompt token (the token-by-token prefill)
and every decode token, over the loop's own cache (a KV cache for the
attention layer, the conv tail and SSM state for the Mamba layers).

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.data.partition import partition_arrays
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-examples", type=int, default=300)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("jamba-v0.1-52b")
    x, y = lm_examples(seed=0, n=args.n_examples, seq_len=24,
                       vocab=cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K=3, seed=0),
                           batch_size=6)
    learner = CoLearner(
        CoLearnConfig(n_participants=3, T0=1, max_rounds=2, eta0=0.05),
        loss_fn=lambda p, b: tr.loss_fn(p, cfg, {"tokens": b[0],
                                                 "labels": b[1]}),
        device=dev)
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    for i in range(2):
        state = learner.run_round(
            state, lambda i_, j_: tuple(stage(a, device=dev)
                                        for a in data.epoch_batches(i_, j_)))
        print(f"round {i}: loss={np.mean(state['log'][-1].local_losses):.3f}")

    params = learner.shared_model(state)

    B, prompt_len, new_tokens, max_seq = 4, 8, 12, 32
    prompts = torch.as_tensor(x[:B, :prompt_len], device=dev)
    # prefill token by token, then greedy decode: every token one replay
    loop = ServeLoop(cfg, params, batch=B, max_seq=max_seq, device=dev)
    gen, _ = loop.generate(prompts, new_tokens)
    print("prompt[0]:", prompts[0].tolist())
    print("generated[0]:", gen[0].tolist())
    print("cache kinds:", sorted({k.split(':')[0] for k in cfg.layer_kinds()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
