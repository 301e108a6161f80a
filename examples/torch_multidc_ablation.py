"""Scenario: the paper's Figure-2 ablation, end to end, on the PyTorch
port (``repro_torch``).

Compares CLR+ILE / CLR+FLE / ELR+ILE / ELR+FLE on the CIFAR-like synthetic
image task with a tiny ResNet across 5 simulated data centers, plus the
vanilla (centralized) and ensemble baselines of Table 2.

Run:  PYTHONPATH=src python examples/torch_multidc_ablation.py [--device cpu]
      [--rounds 5] [--n-examples 3000]
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.paper_tasks.ablation import run as run_ablation
from repro_torch.paper_tasks.cifar_like import run as run_cifar


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--n-examples", type=int, default=3000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== Fig.2 ablation (resnet_tiny, 5 data centers) ==")
    rows = run_ablation(models=("resnet_tiny",), rounds=args.rounds,
                        n=args.n_examples, device=dev)
    best = max(rows, key=lambda r: r["final_acc"])
    print(f"best combo: {best['combo']} (paper: clr+ile)")

    print("\n== Table 2: vanilla vs ensemble vs co-learning ==")
    run_cifar(models=("vgg_tiny", "resnet_tiny"), rounds=args.rounds,
              n=args.n_examples, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
