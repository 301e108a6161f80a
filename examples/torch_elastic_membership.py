"""Elastic membership: a data center crashes mid-run and warm-rejoins, on
the PyTorch port (``repro_torch``).

The paper assumes a static set of K participants; its whole failure story
is one sentence — restart the failed participant's local training from
the shared model. ``repro_torch.core.membership`` turns that into a layer:
a ``ChurnSchedule`` decides WHO is live each round, the liveness mask
rides into the round graphs (captured once on the card) as a static
device buffer, and the aggregators renormalize their mixing over the live
set so a dead slot neither uploads, downloads, nor counts in the mean.

This walkthrough scripts the paper's scenario exactly: data center 1
crashes during round 2 and comes back in round 4. While it is down its
slot is an identity carry (parameters AND optimizer state frozen); on
rejoin ``CoLearner.restart_participant`` warm-starts it from the last
*synced* shared model, and training proceeds — same graphs, no new
capture, every round logged with its live count.

Run:  PYTHONPATH=src python examples/torch_elastic_membership.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core.api import FusedEngine
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.core.membership import ScriptedChurn
from repro_torch.data.partition import partition_arrays
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr

K, ROUNDS = 4, 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-examples", type=int, default=480)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("internlm2-1.8b")       # reduced dense GQA model
    x, y = lm_examples(seed=0, n=args.n_examples, seq_len=32,
                       vocab=cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K=K, seed=0),
                           batch_size=8)

    # the fault-injection trace: slot 1 dies at round 2, warm-rejoins at 4
    churn = ScriptedChurn(events=(("crash", 2, 1), ("rejoin", 4, 1)))

    learner = CoLearner(
        CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=0.05,
                      max_rounds=ROUNDS),
        loss_fn=lambda p, b: tr.loss_fn(p, cfg, {"tokens": b[0],
                                                 "labels": b[1]}),
        round_engine=FusedEngine(),   # churn rides into the captured graphs
        churn=churn,                  # ...as a static (K,) liveness row
        device=dev,
    )
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))

    for i in range(ROUNDS):
        state = learner.run_round(
            state, lambda i_, j_: tuple(stage(a, device=dev)
                                        for a in data.epoch_batches(i_, j_)))
        log = state["log"][-1]
        ev = state["membership"].round_events(i)
        ev_s = "".join(f"  <-- slot {k} {kind}s" for _, k, kind in ev)
        print(f"round {log.round}: live={log.live}/{K} "
              f"loss={np.mean(log.local_losses):.3f} "
              f"|Δw̄|/|w̄|={log.rel_change:.4f} "
              f"comm={log.comm_bytes / 2**20:.1f}MiB{ev_s}")

    print("membership event log:", state["membership"].events)
    print("shared model params:",
          tr.count_params(learner.shared_model(state)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
