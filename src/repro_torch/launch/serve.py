"""Batched decode CLI (serving of a reduced model).

Ported from ``repro/launch/serve.py``: a thin CLI over
:class:`repro_torch.serving.ServeLoop` that prefills a batch of prompts
and then greedily decodes through the loop's one decode step (a captured
CUDA graph on the card, replayed for every token), against a
KV cache (``--arch internlm2-1.8b``), the recurrent state
(``--arch xlstm-1.3b``) or both, the Mamba layers' conv tail and SSM
state beside the attention layer's KV cache (``--arch jamba-v0.1-52b``),
or MLA's latent cache (``--arch deepseek-v3-671b``); ``--arch`` takes
any of the ten registered architectures' smoke configs, as the JAX CLI
does (internvl2-76b decodes tokens only, as there). It takes the JAX
CLI's flags plus ``--device``,
which defaults to cuda and raises without a card unless ``cpu`` is
passed. Params come from the port's own initializer and the prompts from
numpy, both seeded by ``--seed``.

Usage: PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
           [--arch xlstm-1.3b|jamba-v0.1-52b|deepseek-v3-671b|...] \
           --batch 4 --prompt-len 16 --new-tokens 16 --max-seq 64
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.serving import ServeLoop


def prefill_into_cache(loop: ServeLoop, tokens):
    """Sequential prefill through the loop's captured step (one graph
    replayed per position) into the loop's own cache, reset first; returns
    (last logits (B, 1, V), cache)."""
    return loop.prefill(tokens)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default cuda; raises "
                         "without a card unless cpu is asked for)")
    args = ap.parse_args(argv)
    if args.max_seq < args.prompt_len + args.new_tokens:
        ap.error(f"--max-seq {args.max_seq} < --prompt-len {args.prompt_len}"
                 f" + --new-tokens {args.new_tokens}: decode would index "
                 "past the KV cache")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = tr.init_params(args.seed, cfg, torch.float32, device=device)
    prompts = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), device=device)

    loop = ServeLoop(cfg, params, batch=args.batch, max_seq=args.max_seq,
                     device=device)
    gen, stats = loop.generate(prompts, args.new_tokens)
    print(f"{cfg.name}: prefill {args.prompt_len} tok in "
          f"{stats['prefill_s']:.2f}s, decoded {args.new_tokens} tok in "
          f"{stats['decode_s']:.2f}s ({stats['tokens_per_s']:.1f} tok/s "
          f"batch={args.batch}, {stats['compile_count']} compile, "
          f"device={device})")
    print("generated[0]:", gen[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
