"""Tiny versions of the cells' configurations and traffic, for the CPU
tests: the same files' keys at widths a test run can hold."""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

DENSE = {
    "name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64,
    "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab_size": 256,
    "head_dim": 16, "norm_eps": 1e-05, "rope_theta": 10000.0,
    "tie_embeddings": False, "segments": [[["gqa:dense"], 2]]}

HYBRID = {
    "name": "tiny-hybrid", "family": "hybrid", "n_layers": 4, "d_model": 64,
    "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab_size": 256,
    "head_dim": 16, "norm_eps": 1e-05, "rope_theta": 10000.0,
    "tie_embeddings": False, "n_experts": 4, "top_k": 2, "moe_d_ff": 64,
    "capacity_factor": 1.25, "router_aux_coef": 0.01, "ssm_state_dim": 8,
    "ssm_conv_dim": 4, "ssm_expand": 2, "ssm_dt_rank": 4,
    "segments": [[["mamba:dense", "mamba:moe", "gqa:dense", "mamba:moe"], 1]]}

TRAFFIC = {
    "round": {"entry": "round", "participants": 3, "steps_per_epoch": 2,
              "batch": 4, "seq_len": 16, "epochs": 1, "codec": "fused",
              "codec_bits": 8, "block": 256, "schedule": "clr", "eta0": 0.01,
              "decay_rate": 0.25, "remat": True, "checked_rounds": 3,
              "traced_calls": 1},
    "prefill": {"entry": "prefill", "batch": 2, "seq_len": 32,
                "impl": "kernel", "checked_calls": 2, "traced_calls": 1},
    "decode": {"entry": "decode", "batch": 2, "prompt": 4, "new": 6,
               "max_seq": 16, "checked_requests": 2, "traced_calls": 1},
}

#: the cells' limits at these sizes, for the fault tests; the real
#: limits are the workload files'
LIMITS = {"round": {"loss_gap": 1e-5, "update1_gap": 1e-3,
                    "update3_gap": 1e-3},
          "prefill": {"logit_gap": 1e-4},
          "decode": {"served_gap": 1e-4}}


def config(model, base="internlm2-1.8b"):
    cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
    cfg["model"] = copy.deepcopy(model)
    return cfg


def run(entry, model, seed=7, seconds=0.0, trace=False, traffic=None,
        probe=None):
    """(result, driver's Run) of a tiny cell on the CPU."""
    from bench import harness
    cell = f"tiny-{entry}"
    wl = {"config": model["name"], "traffic": entry, "chips": 1,
          "limits": LIMITS[entry]}
    spec = {"end_to_end": [], "per_layer": []}
    r = harness.Run(cell, wl, config(model),
                    copy.deepcopy(traffic or TRAFFIC[entry]), seed,
                    seconds, trace, "cpu", time.perf_counter())
    return harness.run_cell(r, spec, probe), r
