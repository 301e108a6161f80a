"""Table 2 analog on the port: vanilla vs ensemble vs co-learning, three
image archs (ported from ``benchmarks/cifar_like.py``).

Paper claim C1: co-learning ≈ vanilla; ensemble ~10 pts worse.

Usage:
  PYTHONPATH=src python -m repro_torch.paper_tasks.cifar_like [--device cpu]
  PYTHONPATH=src python -m repro_torch.paper_tasks.cifar_like --check
"""
from __future__ import annotations

import argparse

from repro_torch.data.synthetic import image_like
from repro_torch.device import resolve_device
from repro_torch.models.convnets import IMAGE_MODELS
from repro_torch.paper_tasks.harness import (run_colearn, run_ensemble,
                                             run_vanilla)


def run(models=("vgg_tiny", "resnet_tiny", "densenet_tiny"), rounds=6,
        n=4000, seed=0, quiet=False, device=None):
    dev = resolve_device(device)
    xtr, ytr = image_like(seed, n=n)
    xte, yte = image_like(seed + 1000, n=1000)
    rows = []
    for name in models:
        init_fn, apply_fn = IMAGE_MODELS[name]
        van = run_vanilla(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                          epochs=rounds, seed=seed, device=dev)
        ens = run_ensemble(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                           K=5, epochs=rounds, seed=seed, device=dev)
        col = run_colearn(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                          K=5, rounds=rounds + 2, T0=1, epsilon=0.03,
                          seed=seed, device=dev)
        rows.append({"model": name, "vanilla": van["acc"][-1],
                     "ensemble": ens["acc"], "colearn": col["acc"][-1],
                     "local_mean": sum(ens["local_acc"]) / len(ens["local_acc"])})
        if not quiet:
            r = rows[-1]
            print(f"table2,{name},vanilla={r['vanilla']:.4f},"
                  f"ensemble={r['ensemble']:.4f},colearn={r['colearn']:.4f},"
                  f"local_mean={r['local_mean']:.4f}", flush=True)
    return rows


def check(device=None):
    """CI smoke: one tiny arch, tiny corpus, 1 round — asserts the three
    baselines still run end-to-end and report sane accuracies."""
    rows = run(models=("vgg_tiny",), rounds=1, n=320, quiet=True,
               device=device)
    assert len(rows) == 1
    r = rows[0]
    for key in ("vanilla", "ensemble", "colearn", "local_mean"):
        assert 0.0 <= r[key] <= 1.0, (key, r)
    print("cifar_like --check OK", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--check", action="store_true",
                    help="fast CI smoke mode: one tiny arch, 1 round")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.check:
        return check(device=args.device)
    run(rounds=args.rounds, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
