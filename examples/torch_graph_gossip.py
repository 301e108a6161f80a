"""Graph gossip: decentralized rounds over a sparse topology, plus D², on
the PyTorch port (``repro_torch``).

The paper's server averages all K uploads every round (Eq. 2) — an O(K)
all-to-all. ``repro_torch.core.topology`` replaces the server with a
communication graph: each data center exchanges parameters only with its
graph neighbors, mixing with Metropolis–Hastings doubly-stochastic
weights, so the per-round wire bill is O(degree) while repeated rounds
still drive all replicas to the same consensus (rate set by the graph's
spectral gap). ``D2Gossip`` adds the D² / Exact-Diffusion correction on
top of the same graph — a per-slot memory that cancels the bias sparse
mixing picks up when shards are non-IID.

This walkthrough trains 8 "data centers" on a hypercube (each talks to
log2(K)=3 neighbors), prints the spectral-gap diagnostic for several
registered topologies, and compares the per-round bill against the dense
all-to-all. The time-varying one-peer exponential graph shows topology as
data: the graph changes every round, the captured round graph does not
(the mixing matrix rides in one static device buffer).

Run:  PYTHONPATH=src python examples/torch_graph_gossip.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core.api import D2Gossip, FusedEngine, GraphGossip
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.core.topology import get_topology
from repro_torch.data.partition import partition_arrays
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves, tree_map

K, ROUNDS = 8, 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-examples", type=int, default=640)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # spectral gap of I - W bounds the consensus rate: bigger gap, faster
    # mixing, and (for the sparse graphs) a far smaller per-edge wire bill
    print(f"topology diagnostics at K={K}:")
    for name in ("ring", "grid2d", "hypercube", "exponential", "complete"):
        t = get_topology(name)
        print(f"  {name:<12} max_degree={t.degree(0, K)} "
              f"spectral_gap={t.spectral_gap(K):.3f}"
              f"{'  (time-varying, period-averaged)' if t.time_varying else ''}")

    cfg = get_smoke_config("internlm2-1.8b")       # reduced dense GQA model
    x, y = lm_examples(seed=0, n=args.n_examples, seq_len=32,
                       vocab=cfg.vocab_size)
    data = ParticipantData(partition_arrays([x, y], K=K, seed=0),
                           batch_size=8)

    learner = CoLearner(
        CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=0.05,
                      max_rounds=ROUNDS),
        loss_fn=lambda p, b: tr.loss_fn(p, cfg, {"tokens": b[0],
                                                 "labels": b[1]}),
        aggregator=D2Gossip("hypercube"),  # sparse gossip + D² correction
        round_engine=FusedEngine(),        # captured once; W rides as data
        device=dev,
    )
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))

    dense = GraphGossip("complete")
    for i in range(ROUNDS):
        state = learner.run_round(
            state, lambda i_, j_: tuple(stage(a, device=dev)
                                        for a in data.epoch_batches(i_, j_)))
        log = state["log"][-1]
        dense_bytes = dense.comm_bytes(learner.codec, state["params"], i)
        print(f"round {log.round}: loss={np.mean(log.local_losses):.3f} "
              f"|Δw̄|/|w̄|={log.rel_change:.4f} "
              f"comm={log.comm_bytes / 2**20:.1f}MiB/node "
              f"(dense all-to-all would be {dense_bytes / 2**20:.1f}MiB)")

    # doubly-stochastic mixing preserves the replica mean; D²'s corrections
    # sum to zero — the consensus mean is what a deployment would serve
    mean = tree_map(lambda t: t.mean(0), state["params"])
    spread = max(float((p - m[None]).abs().max())
                 for p, m in zip(leaves(state["params"]), leaves(mean)))
    print(f"replica spread around consensus mean: {spread:.4f}")
    print("shared model params:",
          tr.count_params(learner.shared_model(state)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
