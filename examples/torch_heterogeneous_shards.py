"""Scenario: heterogeneous data across the data centers, on the PyTorch
port (``repro_torch``).

The paper trains on equal IID shards; this example exercises the claim it
actually makes — model averaging "on different types of data" — along both
heterogeneity axes:

1. quantity skew — one data center holds 4x the data of the smallest
   (``quantity_skew``). The ragged pipeline pads to the longest shard and
   masks the padding (no shard is clamped, no example dropped), and
   Eq. 2 averaging is example-count weighted (FedAvg, 1602.05629).
2. label skew — each center's class mixture ~ Dirichlet(alpha)
   (``dirichlet_partition``); alpha=0.1 is near single-class shards, the
   regime where decentralized averaging is actually stressed (D²,
   1803.07068).

Every run goes through the fused engine: on the card each round replays
CUDA graphs captured once, the batch mask riding in as a device tensor.

Run:  PYTHONPATH=src python examples/torch_heterogeneous_shards.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.data.synthetic import image_like
from repro_torch.device import resolve_device
from repro_torch.models.convnets import IMAGE_MODELS
from repro_torch.paper_tasks.harness import run_colearn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-examples", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    init_fn, apply_fn = IMAGE_MODELS["resnet_tiny"]
    train = image_like(seed=0, n=args.n_examples)
    test = image_like(seed=1000, n=800)

    print("== quantity skew (sizes 4:2:1:1, weighted vs uniform Eq. 2) ==")
    for weighted in (False, True):
        r = run_colearn(init_fn, apply_fn, train, test, K=4,
                        rounds=args.rounds, T0=1, engine="fused",
                        partition="sizes", sizes=[0.5, 0.25, 0.125, 0.125],
                        weighted=weighted, device=dev)
        print(f"  weighted={weighted}: shards={list(r['shard_sizes'])} "
              f"acc/round={[f'{a:.3f}' for a in r['acc']]}")

    print("== label skew (Dirichlet alpha, weighted Eq. 2) ==")
    for alpha in (0.1, 1.0):
        r = run_colearn(init_fn, apply_fn, train, test, K=4,
                        rounds=args.rounds, T0=1, engine="fused",
                        partition="dirichlet", dirichlet_alpha=alpha,
                        weighted=True, device=dev)
        print(f"  alpha={alpha}: shards={list(r['shard_sizes'])} "
              f"acc/round={[f'{a:.3f}' for a in r['acc']]}")

    print("every example trained: shard sizes above always sum to",
          np.sum(r["shard_sizes"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
