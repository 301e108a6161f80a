#!/usr/bin/env python3
"""Where a decode step's time goes, captured and eager, on one CUDA card.

    python3 tools/decode_profile.py [--models internlm2,xlstm,jamba]

For each served model at the width ``chip_smoke.py`` serves it
(internlm2-1.8b at 24 layers, xlstm-1.3b at 48, one full-width period of
jamba-v0.1-52b; random f32 params, TF32 off), a ``ServeLoop`` at batch 8
(max_seq 256) prefills a 128-token prompt, then the same decode step runs
two ways at the next position, each ``--steps`` times after a warm-up:

- ``captured``: the loop's graph replayed (``ServeLoop._run_step``);
- ``eager``: ``transformer.decode_step`` on the loop's cache and buffers.

Each is timed with CUDA events around the run (ms a step), then run once
more under ``torch.profiler`` (CPU and CUDA activities): the device time
of its kernels (a step's sum, their count and the top kernels by name)
and the busy share of the device, the kernels' union over the window
between the first kernel's start and the last one's end. Beside them
stands the step's bound from ``chip_smoke.py`` (weights, and for xlstm
and jamba the decode state read and written, over the card's HBM rate).
The decode state is not reset between steps, so the position stays
fixed and the work of every step is the same.

Prints one JSON object and writes it to ``build/decode_profile.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODELS = ("internlm2", "xlstm", "jamba")


def _cfg(name):
    import chip_smoke
    from repro_torch.configs import get_config
    if name == "jamba":
        return chip_smoke.jamba_cfg()
    return get_config({"internlm2": "internlm2-1.8b",
                       "xlstm": "xlstm-1.3b"}[name])


def _bound_ms(torch, cfg, params, B, bw):
    """``chip_smoke.py``'s decode bound: weights plus the decode state
    read and written (the recurrent and Mamba states; the KV cache of
    jamba's attention layer), over ``bw``."""
    import chip_smoke
    kinds = cfg.layer_kinds()
    state = 0
    if cfg.name.startswith("xlstm"):
        n_ml = sum(k.startswith("mlstm") for k in kinds)
        H, d = cfg.n_heads, cfg.d_model
        hd = int(cfg.xlstm_proj_factor * d) // H
        state = 4 * B * H * (n_ml * (hd * hd + hd + 1)
                             + (len(kinds) - n_ml) * 4 * (d // H))
    elif cfg.n_experts:
        di, st, K = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.ssm_conv_dim
        n_m = sum(k.startswith("mamba") for k in kinds)
        n_a = sum(k.startswith("gqa") for k in kinds)
        state = 4 * B * (n_m * ((K - 1) * di + di * st)
                         + n_a * 2 * 256 * cfg.n_kv_heads * cfg.head_dim)
    return 1e3 * (chip_smoke.decode_weight_bytes(params, cfg, B)
                  + 2 * state) / bw


def _events_ms(torch, fn, steps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(steps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / steps


def _profile(torch, fn, steps):
    """Kernel time a step, kernels a step, the top kernels and the busy
    share of the device over the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        if b <= a:
            continue
        spans.append((a, b))
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + (b - a), n + 1)
    if not spans:
        return {"kernels_seen": 0}
    spans.sort()
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = spans[-1][1] - spans[0][0]
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"kernels_seen": len(spans),
            "kernels_per_step": len(spans) / steps,
            "kernel_ms_per_step": total / 1e3 / steps,
            "busy_share": busy / window,
            "window_ms_per_step": window / 1e3 / steps,
            "top": [{"name": n[:120], "ms_per_step": t / 1e3 / steps,
                     "per_step": c / steps} for n, (t, c) in top]}


def run(torch, name, steps, bw):
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeLoop
    dev = torch.device("cuda")
    cfg = _cfg(name)
    B, P, max_seq = 8, 128, 256
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device=dev)
    loop = ServeLoop(cfg, params, batch=B, max_seq=max_seq, device=dev)
    loop.prefill(prompts)
    loop._pos.copy_(loop._positions[P])

    def captured():
        loop._run_step()

    def eager():
        tr.decode_step(loop.params, cfg, loop._cache, loop._token,
                       loop._pos)
    rec = {"model": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "position": P, "steps": steps,
           "bound_ms_per_step": _bound_ms(torch, cfg, params, B, bw)}
    for label, fn in (("captured", captured), ("eager", eager),
                      ("captured_again", captured)):
        rec[label] = {"ms_per_step": _events_ms(torch, fn, steps),
                      **_profile(torch, fn, max(steps // 4, 2))}
    rec["captures"], rec["replays"] = loop.compile_count(), \
        loop.replay_count()
    del loop, params, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("decode_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    out = {"device": name, "smi": chip_smoke.run_cmd(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]),
        "models": [run(torch, m, args.steps, chip_smoke.mem_bandwidth(name))
                   for m in args.models.split(",")]}
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "decode_profile.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
