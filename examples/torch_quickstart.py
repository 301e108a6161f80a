"""Quickstart: co-learning (the paper's Algorithm 1) in ~40 lines, on the
PyTorch port (``repro_torch``).

Five "data centers" each hold a disjoint shard of a synthetic LM corpus;
they train locally with the cyclical learning rate (Eq. 3), the server
averages parameters (Eq. 2) and doubles local epochs when the shared model
stabilizes (Eq. 4).

The round strategy is composed explicitly from the five protocols in
``repro_torch.core.api`` — the wire codec (ExactF32: paper-faithful f32
uploads), the aggregator (FullAverage: Eq. 2), the round engine
(PythonEngine: the reference host loop), the learning-rate schedule (CLR:
Eq. 3, restarting at η^i every round), and the sync policy (ILE: Eq. 4,
doubling local epochs once the shared model stabilizes). Swap any piece
independently: e.g. ``codec=FlatFusedInt8()`` for int8 flat-buffer uploads
(see examples/torch_compressed_wan.py), ``aggregator=PartialParticipation(
m=2)`` for FedAvg-style sampled uploads, ``round_engine=FusedEngine()``
for every round as replays of CUDA graphs captured once,
``schedule=WarmupCLR()`` to ramp η^i over the first rounds, or
``sync_policy=DivergenceTrigger(delta=...)`` to communicate only when the
local models have diverged (Kamp et al.).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core.api import CLR, ILE, ExactF32, FullAverage, PythonEngine
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.data.partition import partition_arrays
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-examples", type=int, default=600)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("internlm2-1.8b")       # reduced dense GQA model
    x, y = lm_examples(seed=0, n=args.n_examples, seq_len=32,
                       vocab=cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K=5, seed=0),
                           batch_size=8)

    learner = CoLearner(
        CoLearnConfig(n_participants=5, T0=1, eta0=0.05, epsilon=0.05,
                      max_rounds=4),
        loss_fn=lambda p, b: tr.loss_fn(p, cfg, {"tokens": b[0],
                                                 "labels": b[1]}),
        codec=ExactF32(),                   # paper-faithful f32 wire
        aggregator=FullAverage(),           # Eq. 2 over all K participants
        round_engine=PythonEngine(),        # reference per-epoch host loop
        schedule=CLR(eta0=0.05),            # Eq. 3: restart at eta^i
        sync_policy=ILE(epsilon=0.05),      # Eq. 4: double T_i when stable
        device=dev,
    )
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))

    for _ in range(4):
        state = learner.run_round(
            state, lambda i_, j_: tuple(stage(a, device=dev)
                                        for a in data.epoch_batches(i_, j_)))
        log = state["log"][-1]
        print(f"round {log.round}: T_i={log.T} lr {log.lr_first:.3f}->"
              f"{log.lr_last:.4f} loss={np.mean(log.local_losses):.3f} "
              f"|Δw̄|/|w̄|={log.rel_change:.4f} next_T={state['ctrl'].T} "
              f"comm={log.comm_bytes/2**20:.1f}MiB")

    print("shared model params:",
          tr.count_params(learner.shared_model(state)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
