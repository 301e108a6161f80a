"""Tables 3–6 analog on the port: vanilla vs co-learning across the
modalities (image handled by ``cifar_like``; here text + audio, incl. the
CRNN pooling variants of Table 6), ported from ``benchmarks/tasks.py``.
Paper claim C1/C4: parity across tasks and archs.

Usage:
  PYTHONPATH=src python -m repro_torch.paper_tasks.tasks [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.data.synthetic import audio_like, text_like
from repro_torch.device import resolve_device
from repro_torch.models.convnets import AUDIO_MODELS, TEXT_MODELS
from repro_torch.paper_tasks.harness import run_colearn, run_vanilla


def run(rounds=5, seed=0, quiet=False, device=None):
    dev = resolve_device(device)
    rows = []
    xtr, ytr = text_like(seed, n=4000)
    xte, yte = text_like(seed + 1000, n=1000)
    for name, (init_fn, apply_fn) in TEXT_MODELS.items():
        van = run_vanilla(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                          epochs=rounds, seed=seed, device=dev)
        col = run_colearn(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                          K=5, rounds=rounds, T0=1, epsilon=0.03, seed=seed,
                          device=dev)
        rows.append({"task": "text", "model": name,
                     "vanilla": van["acc"][-1], "colearn": col["acc"][-1]})
        if not quiet:
            r = rows[-1]
            print(f"table4,{name},vanilla={r['vanilla']:.4f},"
                  f"colearn={r['colearn']:.4f}", flush=True)

    xtr, ytr = audio_like(seed, n=4000)
    xte, yte = audio_like(seed + 1000, n=1000)
    for name, (init_fn, apply_fn) in AUDIO_MODELS.items():
        van = run_vanilla(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                          epochs=rounds, seed=seed, device=dev)
        col = run_colearn(init_fn, apply_fn, (xtr, ytr), (xte, yte),
                          K=5, rounds=rounds, T0=1, epsilon=0.03, seed=seed,
                          device=dev)
        rows.append({"task": "audio", "model": name,
                     "vanilla": van["acc"][-1], "colearn": col["acc"][-1]})
        if not quiet:
            r = rows[-1]
            print(f"table56,{name},vanilla={r['vanilla']:.4f},"
                  f"colearn={r['colearn']:.4f}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
