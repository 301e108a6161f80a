#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase; exits 0 only if all pass
    python3 chip_smoke.py --quick    # phases 1-3 at small shapes only

Phases:
  1. device: name, capability (must be 9.0), power limit, versions;
  2. build the kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
     source, all started together);
  3. each kernel (K1-K8) against its plain PyTorch version on the card
     at small odd shapes and at the main path's shapes (K5 at
     internlm2-1.8b's and jamba-v0.1-52b's attention and at phase 13's:
     arctic-480b's 56 / 8 heads, qwen1.5-32b's MHA 40 / 40 and
     musicgen-large's 32 / 32 at head size 64; K1 and K2 both
     over the leaves of the K=3 stacked tree and once over its flat
     (3, N_pad) buffer, bit for bit), timed with CUDA
     events (median of >= 10 runs after warm-up; the plain mLSTM and
     selective-scan loops of 2048 steps, >= 3) beside the plain version,
     the bound and, for K5, ``F.scaled_dot_product_attention`` (the
     library yardstick, which the port never calls; no PyTorch call
     computes K6's or K7's recurrence). K5 and K7 run their products on
     the tensor cores in 3xTF32: their bound is taken at a third of the
     TF32 rate, with the CUDA-core bound they were held to before beside
     it (``bound_f32_cuda_ms``), their achieved TFLOP/s, each kernel's
     registers and spills from ``-Xptxas -v``, and K7's device time per
     pass (``torch.profiler``). K6 is held at 1e-5 with dt and A drawn
     three ways (``SS_REGIMES``) and reports its registers, its SASS
     instructions per state update (``cuobjdump``), the share of its exps
     on the SFU (MUFU.EX2 in that loop), and the SFU's exp time beside its
     byte bound. K8 (decode attention) is held at 1e-5 for G 1-8 and hd
     32 / 64 / 128 around its 64-slot chunks and a wrapped window, and
     timed at the decode cell's shape (B 32, S 512, 16 / 8 heads of 128)
     at positions 127, 256 and 511 with the L2 cache refilled before
     each run, beside its byte bound, the plain version and
     ``F.scaled_dot_product_attention(enable_gqa=True)`` over the valid
     slots (the library yardstick);
  4. a small Algorithm 1 run (smoke config, K=3, 3 rounds, fused codec)
     through the fused engine: the card's captured rounds (one capture,
     two replays, each window under ``set_sync_debug_mode("error")``, K3
     counted once per replayed round) against the same rounds run
     uncaptured on the CPU; then three strategy runs, each card against
     CPU at 1e-4 with equal sync patterns and comm bytes: the divergence
     trigger under fused int4 with error feedback (K4 only on synced
     rounds, the residual unchanged across a quiet round), partial
     participation (m=2) over the fused int8 codec's flat roundtrip (K1
     and K2 once a round), ragged shards of 3, 2 and 1 batches under
     their mask; then the membership runs, card against CPU at 1e-4 with
     equal live counts, patterns and bills, no capture after round 0's,
     every window under the sync guard: (i) ``ScriptedChurn`` on K = 3
     plus one standby slot (slot 1 crashes at round 1 and rejoins at 3,
     the standby joins at 2), fused int8, FullAverage, both engines, 4
     rounds: every dead row bit-unchanged through its dead rounds, every
     joined row equal to ``prev_avg`` at its first round; (ii) D² over
     the ring, leafwise int4 with error feedback, under (i)'s churn, 4
     rounds (K1/K2 once per leaf a round); (iii) GraphGossip over the
     exponential graph, K = 4, 3 rounds, its matrix changing every
     round; (iv) (ii)'s round state saved after round 2, restored into a
     fresh learner and into (ii)'s own (no capture): rounds 3-4 equal to
     the uninterrupted run bit for bit; and 11(c) (below);
  5. the main path at internlm2-1.8b's full width (depth cut to 16 of 24
     layers, f32, T fixed at 1) through the fused engine, the CLI's
     default: (a) fused
     codec, K=5, 3 rounds (the first captures, two replay), and the same
     cell under the python engine, 2 rounds, for the side-by-side
     numbers; (b) fused int4 with error feedback, K=3, 2 rounds; (c)
     leafwise codec, K=3, 2 rounds. Each round reports its host seconds
     and its epochs / aggregation device time from CUDA events (the
     middle one recorded inside the captured graph, no host sync), and
     the peak memory. The kernels' launch counters are zeroed just
     before each run and read just after (replays add the launches their
     graph recorded); each must show its kernels launched once per round
     (K1/K2 once per quantized leaf);
  6. serving at internlm2-1.8b's full width and all 24 layers, f32:
     (a) ``make_prefill_step(cfg, impl="kernel")`` over 8 x 2048-token
     prompts, twice, K5 launched once per layer per prefill, the second
     with a synchronised span around K5; (b)
     ``ServeLoop``, batch 8, a 128-token prompt, 64 new tokens, max_seq
     256, its decode step captured once as a CUDA graph when the loop is
     built and replayed for every prompt and decode token (one capture,
     ``P + new`` replays a ``generate``), every ``generate`` under
     ``torch.cuda.set_sync_debug_mode("error")``; the decode ms a step
     beside its weight-read bound, the prompt seconds; (c) a second model
     published to a ``ModelBank`` and polled in (copied into the loop's
     params: still one capture), whose tokens must equal an eager
     ``decode_step`` loop of that model, timed beside the loop; (d) the
     token-by-token prefill of a second loop, whose captured step records
     every layer's inputs and outputs, against the kernel prefill at 1e-4:
     every layer on the loop's own inputs to it, and the last-prompt
     logits against ``prefill(impl="kernel")``. The counters are zeroed
     just before (a) and read after (d);
  7. serving xlstm-1.3b at full width and all 48 layers (42 mLSTM, 6
     sLSTM), f32: (a) two prefills of 8 x 2048 tokens through
     ``make_prefill_step(cfg, impl="kernel")``, K7 launched 42 times in
     each and the six sLSTM recurrences replayed from one captured graph
     (captured in the first prefill, 6 replays in the second; one capture
     per prefill shape over the phase), the second with synchronised
     spans around the mLSTM and sLSTM layers and K7; (b)-(d) as in phase
     6, the bound with the decode state read and written, at 2e-4 (the
     JAX suite's tolerance for K7), except that (d) holds only every
     layer to it: the
     random 48-layer model's last-prompt logits differ by far more between
     any two f32 orderings of the same model (the loop, the K7 prefill,
     ``prefill(impl="ref")``), so those distances are recorded side by
     side. The counters are zeroed just before (a) and read after (d);
  8. serving jamba-v0.1-52b at full width, one 8-layer period of the
     published interleave (7 Mamba layers, 1 attention layer, MoE FFNs
     with 16 experts top-2 in 4 of them, dense FFNs in 4), f32: (a) two
     prefills of 8 x 2048 tokens, K6 launched 7 times and K5 once in
     each, the second with synchronised spans around the Mamba layers,
     K6, the MoE FFNs, the dense FFNs, the attention layer and K5; (b) the
     ServeLoop as in phase 6, at the config's capacity factor 1.25; (c)
     the loop's tokens against an eager ``decode_step`` loop of the SAME
     model (two f32 copies of 53 GB do not fit the card, so no second
     model and no swap); (d) as in phase 6 at 1e-4, both sides at a
     drop-free capacity factor (capacity dropping depends on how many
     tokens a call sees). The counters are zeroed just before (a) and
     read after (d);
  9. the rest of the strategy API at internlm2-1.8b's full width and
     phase 5's depth: (a) the divergence trigger, fused int8, K=5, T
     fixed, 4 rounds through the fused engine: round 0 at δ = inf (quiet,
     its divergence div0 reported as rel), then δ = 1.18·div0 swapped in
     with ``set_sync_policy`` (no rebind, no capture); the gate graph
     replayed every round, the finalize graph and K3 only on synced
     rounds, 0 bytes on quiet ones; each round's divergence, δ and margin
     (> 5%), host seconds and device split (epochs, gate, finalize); then
     the same rounds under the python engine on the card: the same
     pattern, losses within 1e-4. (b) partial participation, m=2, over
     the fused int8 codec's flat roundtrip, on ragged shards of 3, 2 and 1
     batches of 8 x 256 (a (3, 3) mask, the shard sizes as the weights),
     K=3, 2 timed rounds of the fused engine as it ships, then 2
     untimed rounds whose captured aggregate also copies its input's
     smaller leaves (norms and attention projections) aside: K1 and K2
     once a round, every participant's new row within 1e-6 of the
     weighted mean of the sampled rows' roundtrip by the plain quantize
     and dequantize, the bill ``ceil(m·up/K) + raw``. The counters are
     zeroed just before each fused run and read after;
 10. churn and gossip at internlm2-1.8b's full width, depth 2 of 24
     (``LAYERS10``; 4 before, 6 before phase 17), K = 5, leafwise int8,
     T fixed
     at 1: (a) slot 3
     crashes at round 1 and rejoins at round 3, FullAverage
     renormalised over the live set, 4 rounds fused, then the same under
     the python engine (losses within 1e-4); (b) GraphGossip over the
     time-varying exponential graph, 3 rounds, the matrix changing each
     round and the bill ``ceil(2·edges·wire/n)``; (c) D² over the ring
     under (a)'s churn, 4 timed rounds, then 2 untimed rounds whose
     aggregate records 2 sampled leaves, every live row's params and
     correction held against the plain roundtrip and the matrix. Per
     round: host seconds, the device split (epochs / finalize, CUDA
     events), live count, bill, matrix, peak memory; one capture set and
     no capture on a leave, a rejoin or a new matrix; K1/K2 once per
     leaf a round; a dead slot's params and round state unchanged. The
     counters are zeroed just before each run and read after;
 11. continuous operation: (a) at internlm2-1.8b's full width and phase
     10's depth, K = 3, fused int8 (K3 every round), ILE with T fixed at
     1, over a token stream under ``CovariateDrift`` (every round's
     contents differ), 4 rounds through the fused engine (round 0
     captures, 1-3 replay), each round published into a shared-mode
     ``ModelBank`` by ``run_round``'s ``on_round_end`` hook and polled
     into a ``ServeLoop`` (batch 8, 128-token prompt, 64 new tokens) that
     then generates: per round the round s, swap ms (synchronised),
     decode tokens/s, prompt s, version, staleness, captures of the round
     graph and the loop (1 each, flat), peak memory and K3 launches; the
     loop's params equal ``shared_model`` bit for bit after each poll,
     the served version's snapshot is unchanged by the next round, the
     tokens after the last swap equal an eager decode loop over the
     bank's params, every round's window under the sync guard; the
     counters are zeroed just before the rounds and read after; (b) the
     continuous CLI (``repro_torch.launch.continuous``) at its smoke
     defaults under the divergence trigger with an abrupt drift at round
     2, 4 rounds, persisting its versions: exit 0, one decode capture;
     (c) run with phase 4: the smoke config, the divergence trigger and
     an abrupt drift through the fused engine with ``publish_from`` as the
     hook, the card against the CPU at 1e-4 with equal sync patterns,
     bills, versions and staleness; (d) every ``examples/torch_*.py``
     once on the card at the sizes its CPU test runs (``EXAMPLES11``;
     exit 0; the compressed-WAN walkthrough launches K1-K4);
 12. the paper's own tasks (``repro_torch.paper_tasks``): (a) the nine
     convnet / GRU / CRNN testbeds' logits, loss and every gradient on a
     batch of 32, card against CPU from the same params at 1e-5, with
     cuDNN's TF32 switched on globally (the port keeps its convolutions
     in f32 itself); (b) Table 2, ``cifar_like.run()`` at 2 rounds of its
     6 (``ROUNDS12B``; three image models, n = 4,000, K = 5, 5 rounds for
     co-learning):
     each row and each run's seconds, then resnet_tiny's co-learning run
     once more through the fused engine (one round capture per T, its
     replayed rounds' seconds an epoch beside the python engine's, peak
     memory); (c) Tables 4-6, ``tasks.run()`` at 1 round of its 5
     (``ROUNDS12C``), and the heterogeneity sweep,
     ``ablation.heterogeneity()``, at 1 round of its 5 (``SWEEP12C``;
     the partition, and so the shards, unchanged): the sweep's
     shard sizes and coverage equal ``benchmarks/BENCH_heterogeneity.json``
     row for row, its accuracies printed beside the committed JAX rows
     (not held: the inits differ); (d) resnet_tiny, K = 5, the fused
     engine, 2 steps an epoch, 3 rounds, under the fused int8 codec (K3
     once a round) and the leaf-wise one (K1 and K2 once per quantized
     leaf a round), card against CPU at 1e-4 per round (losses, rel, T,
     LR) with equal bills; the counters are zeroed just before each run
     and read after, and land in the kernels line; (e) the two paper-task
     examples as in 11(d), at half their examples and fewer rounds
     (``EXAMPLES12``);
 13. the six architectures ported last, f32: (a) deepseek-v3-671b at
     full width (d 7168, 128 heads, q_lora 1536, kv_lora 512, 256
     experts top-8 plus a shared one, vocab 129,280), cut to one
     ``mla:dense`` and one ``mla:moe`` layer and no MTP head: init (its
     peak against the params' bytes), two prefills of 4 x 2048 with
     synchronised spans (MLA layers, their latent attention, MoE and
     dense FFNs; K5 launched 0 times: MLA never reaches it), then (b)-(d)
     of the serving phases at batch 4 with no swap (two copies do not
     fit) and the loop's prefill at the least drop-free factor
     (``ceil(n_experts / top_k)``), with the latent cache's floats per
     token and layer (576) beside a 128-head K/V cache's, and decode's ms
     a step against two bounds: every weight once (what the capacity
     dispatch reads: all experts) and the routed one (the experts a
     step's 4 x top_k choices can reach, min(E, 4 top_k), beside every
     other weight); (b) arctic-480b at full width, one
     ``gqa:moe_dense`` layer, prefill 8 x 2048 through K5 (one launch a
     prefill) with K5, MoE and dense-FFN spans, then as (a); (c)
     qwen2-72b (QKV biases drawn) and internvl2-76b (256 prefix
     embeddings + 1,792 tokens) at full width, 2 of 80 layers: the K5
     prefill of 8 x 2048 against the plain prefill at 1e-4; (d) the six
     smoke configs card against CPU at 1e-4: the loss (MTP and aux in
     it), every gradient and ``decode_step`` logits; (e) the train CLI,
     fused engine, 2 rounds of deepseek-v3-671b and arctic-480b, and
     internvl2-76b stopping on its missing prefix;
 14. training the recurrent families (the backward pass of the mLSTM,
     sLSTM and selective-scan recurrences through ``layers.
     chunked_scan``: 256-step chunks recomputed in the backward pass),
     f32: (a) xlstm-1.3b at full width (d 2048, 4 heads of 1024, vocab
     50,304), depth 48 -> 2 (1 mLSTM + 1 sLSTM), B 2 x S 512 (two
     chunks a recurrence), K = 2, fused int8, T 1, one step an epoch:
     without per-layer recomputation (``REMAT14``; 16(b) has it on), the
     python engine for 2 rounds, then the fused engine for 3 (one
     capture, two replays), the loss falling, the engines' first two
     rounds within 1e-4, K3 once a round, every window under the sync
     guard; per round the seconds, training tokens/s, the device split
     (epochs / finalize) and peak memory; the capture's recording,
     end-of-capture and instantiation seconds and its node count
     (``graph_stats``); then one mLSTM layer of that width forward and
     backward with the recomputation and without: seconds, peak memory,
     gradients within 1e-6 of their scale; (b) the same for one
     jamba-v0.1-52b ``mamba:dense`` layer at full width (d 4096, d_inner
     8192, state 16), B 4 x S 2048; (c) the xlstm and jamba smoke
     configs at S 512, card against CPU from the same params at 1e-4:
     the loss and every gradient, then one fused round each (K = 2,
     captured on the card); (d) the train CLI, 2 rounds of each, under
     the fused engine (its default) and the python engine;
 15. the pod path: ``POD_RANKS`` = 3 ranks on the one card, started by
     spawn, over gloo (NCCL refuses two ranks on one device) with a
     ``file://`` rendezvous under ``build/``, each holding its ``(1, ...)``
     row. (a) internlm2-1.8b at full width, depth 24 -> 2 (``LAYERS15``),
     B 8 x 256, 2 steps an epoch, T 1, fused int8, ``FullAverage``, 2
     rounds through ``make_fused_round_step(mesh=...)`` (the epochs
     captured once, the finalize eager: K1 and K2 on the rank's row, one
     all-reduce of the f32 payload, one broadcast of the new shared model
     from rank 0): every rank's params equal rank 0's bit for bit after
     each round, K1 and K2 launched once per rank a round, the loss
     falling; per rank and round the seconds, the epochs and finalize
     device ms (CUDA events), each collective's device-to-host, wire and
     host-to-device seconds and payload bytes beside ``wire_bytes``, the
     peak memory. After the ranks exit, the same rounds on the
     simulation path on the card (K = 3 stacked, ``mesh=None``), each
     round from the pod's params before it (rank 0 saves them): params
     within 1e-5, losses and rel within rtol 1e-5. (b) at the smoke
     config on the same ranks, 2 rounds of each of nine forms (int4 with
     error feedback, leaf-wise int8, weights 3:2:1 on ragged masked
     shards, partial participation m = 2, ``live`` with rank 1 dead in
     round 1, ``RingGossip``, ``GraphGossip`` over the complete graph
     (two point-to-point legs; the exponential graph is time-varying and
     takes the dense fallback, as in the reference), ``D2Gossip`` over
     the ring, the dense fallback over the exponential graph, flagged),
     each round then run by rank 0 on the simulation path on the card
     from the gathered rows: params and round state within 1e-5, losses
     and rel within rtol 1e-5, equal ``comm_bytes``; the error-feedback
     residual nonzero and on its rank, the dead row unchanged bit for bit.
     The ranks report their K1 / K2 launches, which join the kernels
     line;
 16. per-layer recomputation (``remat=True``, the reference's default and
     the port's: each repeat of each segment under one non-reentrant
     checkpoint) and the guards of ``repro_torch.analysis``: (a)
     internlm2-1.8b at full width and phase 5's depth, K = 3, fused int8,
     T 1, batch 8 x 256, 2 steps an epoch, the fused engine: one capture
     round and two replays with ``remat`` on, then the same with it off,
     from the same params and batches: per run the replayed round s, the
     capture round s, the capture's recording / instantiation s and node
     count (``graph_stats``), peak allocated and reserved GB, each round's
     model TFLOP/s from ``launch/analytic.model_flops``; the shared model
     after each round equal at 1e-5 between the two runs, K3 once a round
     in both; beside it one eager step of one participant both ways (its
     peak over the params); (b) xlstm-1.3b at phase 14's depth, B 2 x S
     512: one eager step of one participant both ways (the recurrences'
     256-step checkpoints nested in the layers'), s and peak GB, every
     gradient within 2e-4 (K7's f32 limit); (c) (a)'s replays under
     ``guards.no_transfer(dev)`` and ``guards.no_retrace(limit=1)``, and
     two negative controls that must raise: a ``.item()`` inside
     ``no_transfer``, and the round graph given a second argument layout
     (raised before capturing). Phase 14(a) trains with ``remat`` off
     (``REMAT14``, its record says why);
 17. the intra-pod mesh: ``IP_RANKS`` = 4 ranks on the one card, spawned
     as phase 15's, over ``"staged"`` (``collectives.StagedGroup``: each
     collective through the host over gloo; gloo's own CUDA path crashes
     on DTensor's functional collectives). First a probe: two ranks run
     ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
     ``all_to_all_single`` and ``all_reduce`` on CUDA tensors over a gloo
     pair, each result kept. (a) mesh (data 2, model 2), internlm2-1.8b
     at full width, depth 2: a train step at B 8 x S 256, a prefill and 2
     decode steps on ``cache_specs``' placements, each held against the
     same step run unsharded on the card at 1e-5 (the prefill, where the
     unsharded f32 prefill is itself farther than 1e-5 from an f64 one,
     held to be no farther from the f64 prefill than it); (b) mesh (pod
     2, data 1, model 2): one fused round, K 2, exact (at 1e-5 against
     the simulation path) and 8-bit flat (K1 and K2 once a round on each
     rank's gathered pod row; its params within one int8 step, its
     losses and Eq. 4 at 1e-5), and the 8-bit flat aggregate alone from
     the same rows at 1e-5, both pods' rows equal bit for bit. Each rank
     records its peak GB and every collective's calls, bytes and seconds.
Before the last line come the ``kernels`` JSON and the card's name and
power limit as ``nvidia-smi`` gives them; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
A record of every phase goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RECORD = {}

# f32 tolerances of the kernels against their plain versions (the JAX
# suite's: tests/test_kernels.py)
TOL8 = {"rtol": 1e-7, "atol": 1e-6}
TOL41 = {"rtol": 2e-6, "atol": 2e-6}
WIRE_SRC = "src/repro_torch/kernels/csrc/wire.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
MLSTM_SRC = "src/repro_torch/kernels/csrc/mlstm.cu"
SCAN_SRC = "src/repro_torch/kernels/csrc/selective_scan.cu"
DECODE_SRC = "src/repro_torch/kernels/csrc/decode_attention.cu"
# name in ops.KERNELS: (tag, TPU kernel it replaces, source)
KERNEL_META = {
    "wire_quantize": ("K1", "repro/kernels/quantize.py:99", WIRE_SRC),
    "wire_dequantize": ("K2", "repro/kernels/quantize.py:125", WIRE_SRC),
    "wire_quant_avg_dequant": ("K3", "repro/kernels/comm.py:74", WIRE_SRC),
    "wire_quant_avg_dequant_ef": ("K4", "repro/kernels/comm.py:97",
                                  WIRE_SRC),
    "flash_attention": ("K5", "repro/kernels/flash_attention.py:66",
                        FLASH_SRC),
    "selective_scan": ("K6", "repro/kernels/selective_scan.py:62",
                       SCAN_SRC),
    "mlstm": ("K7", "repro/kernels/mlstm.py:61", MLSTM_SRC),
    "decode_attention": ("K8", "none (repro/models/attention.py "
                         "decode_attend is plain jnp)", DECODE_SRC),
}
# K5 against its plain version: the JAX suite's tolerances
# (tests/test_kernels.py: f32 2e-5, bf16 2e-2)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, Sq, Sk, H, KV, hd, hd_v, window): MHA / GQA / MQA, ragged tails,
# Sq < Sk, hd_v != hd, windows, one query row
FA_SMALL = [(1, 128, 128, 4, 4, 32, 32, 0), (2, 256, 256, 8, 2, 64, 64, 0),
            (1, 128, 128, 4, 1, 32, 32, 0), (2, 512, 512, 4, 2, 128, 128, 0),
            (2, 200, 200, 4, 2, 128, 128, 0), (1, 77, 333, 4, 2, 128, 96, 0),
            (1, 256, 256, 4, 2, 32, 32, 32), (1, 256, 256, 4, 2, 32, 32, 128),
            (2, 150, 300, 6, 3, 16, 16, 100), (1, 1, 70, 2, 1, 128, 128, 0),
            # one below and one above K5's tiles: a block holds 128 rows of
            # one GQA group (128 / (H/KV) positions) and walks 64-key tiles;
            # GQA ratios 1, 2 and 4, hd_v != hd
            (1, 127, 127, 4, 4, 64, 64, 0), (1, 129, 129, 4, 4, 64, 48, 0),
            (2, 63, 63, 8, 4, 64, 64, 0), (2, 65, 129, 8, 4, 128, 96, 0),
            (1, 31, 65, 8, 2, 32, 32, 0), (1, 33, 63, 8, 2, 128, 64, 0)]
# K5 at the serving paths' shapes, 8 x 2048 tokens: internlm2-1.8b's heads
# (phase 6, the kernels line's K5 entry) and jamba-v0.1-52b's attention
# layer (phase 8: 4 query heads per KV head)
FA_PATH = (8, 2048, 2048, 16, 8, 128, 128, 0)
FA_PATH_JAMBA = (8, 2048, 2048, 32, 8, 128, 128, 0)
# ... and the attention shapes phase 13's architectures give it: arctic-
# 480b's 56 / 8 heads (group 7), qwen1.5-32b's MHA 40 / 40 and
# musicgen-large's 32 / 32 at head size 64 (qwen2-72b's and
# internvl2-76b's 64 / 8 are held through their prefills in 13(c))
FA_PATH_NEW = {"arctic-480b": (8, 2048, 2048, 56, 8, 128, 128, 0),
               "qwen1.5-32b": (8, 2048, 2048, 40, 40, 128, 128, 0),
               "musicgen-large": (8, 2048, 2048, 32, 32, 64, 64, 0)}
# K7 against its plain version: the JAX suite's tolerance
# (tests/test_kernels.py). (B, S, H, hd): one step, odd lengths, the JAX
# sweep's shapes and xlstm-1.3b's head size
ML_TOL = {"rtol": 2e-4, "atol": 2e-4}
ML_SMALL = [(2, 1, 3, 64), (2, 37, 3, 128), (2, 300, 3, 1024),
            (1, 64, 2, 32), (2, 128, 4, 64),
            # around K7's chunk of 128 steps (L - 1, L, L + 1, 2L + 3), and
            # head sizes that are not multiples of the products' depth of 8
            (2, 127, 3, 64), (2, 128, 2, 36), (1, 129, 2, 100),
            (1, 259, 2, 128)]
# gate regimes: (ig shift, fg shift, q and k drawn >= 0); see
# tests/test_torch_gpu.py mlstm_inputs for why "positive" draws q, k >= 0
ML_GATES = {"standard": (0.0, 2.0, False), "negative": (-8.0, -8.0, False),
            "positive": (8.0, 8.0, True)}
# K7 at the serving path's shape: xlstm-1.3b's heads, 8 x 2048 tokens
ML_PATH = (8, 2048, 4, 1024)
# K6 against its plain version: the JAX suite's tolerance
# (tests/test_kernels.py). (B, S, di, st): the JAX sweep's shapes, one
# step, a ragged length and width, jamba's width
SS_TOL = {"rtol": 1e-5, "atol": 1e-5}
SS_SMALL = [(1, 64, 128, 8), (2, 128, 256, 16), (1, 256, 128, 4),
            (2, 1, 128, 16), (2, 37, 200, 8), (1, 64, 8192, 16),
            # around K6's chunks of 8 steps (two whole, two and a step)
            (2, 16, 64, 16), (1, 17, 64, 16)]
# how dt and A are drawn (_ss_inputs): the JAX suite's draw, Mamba's
# initialisation (models/mamba.py), strong decay (|dt A| up to 48)
SS_REGIMES = ("jax", "mamba_init", "strong")
# K6 at the serving path's shape: jamba's d_inner and state, 8 x 2048
SS_PATH = (8, 2048, 8192, 16)
# K8 against its plain version (tests/test_torch_gpu.py). Small cases:
# G 1-8 query heads a KV head at hd 32 / 64 / 128, S = 100 (not a multiple
# of the 64-slot chunk), pos at 0, a chunk's last and the next chunk's first
# slot, S - 1, and a sliding window's ring of 100 slots after it wraps
DA_TOL = {"rtol": 1e-5, "atol": 1e-5}
DA_SMALL = [(3, 100, G * 2, 2, hd) for G in (1, 2, 3, 4, 7, 8)
            for hd in (32, 64, 128)]
DA_POS = (0, 63, 64, 99)
# K8 at the decode cell's shape (internlm2-1.8b, batch 32, max_seq 512:
# B, S, H, KV, hd) at three positions
DA_PATH = (32, 512, 16, 8, 128)
DA_PATH_POS = (127, 256, 511)
# depth of the full-width model: 16 of internlm2-1.8b's 24 layers. The
# wire step at K=5 holds 12 model copies (5 stacked, the 5-row flat
# buffer, the mean, prev_avg): 12 x 5.54 GB = 66.5 GB of the card's 80.
LAYERS = 16


def say(phase, **kw):
    RECORD.setdefault(phase, []).append(kw)
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def run_cmd(cmd):
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout or res.stderr).strip()


def mem_bandwidth(name):
    """Published HBM rate of the card the device line names (bytes/s)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12                      # H100 SXM


def f32_peak(name):
    """Published f32 rate outside the tensor cores (flop/s)."""
    if "H100" in name and "PCIe" in name:
        return 51e12
    if "H100" in name and "NVL" in name:
        return 60e12
    return 67e12                        # H100 SXM, H200


def tf32_peak(name):
    """Published dense TF32 tensor-core rate (flop/s); K5 and K7 take three
    TF32 products per f32-accurate product (3xTF32), so their rate is a
    third of it."""
    if "H100" in name and "PCIe" in name:
        return 378e12
    if "H100" in name and "NVL" in name:
        return 417e12
    return 495e12                       # H100 SXM, H200


def tc_bound(name, bw, flops, nbytes, cuda_flops):
    """K5's and K7's bound: the larger of ``flops`` at the 3xTF32 rate and
    ``nbytes`` over the memory rate; beside it the CUDA-core bound they were
    held to before (``cuda_flops`` at the f32 rate, or the bytes)."""
    t_ops = 1e3 * flops / (tf32_peak(name) / 3)
    t_bytes = 1e3 * nbytes / bw
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": ("operations (3xTF32 tensor cores)"
                         if t_ops >= t_bytes else "bytes"),
            "bound_f32_cuda_ms": max(1e3 * cuda_flops / f32_peak(name),
                                     t_bytes)}


def ptxas_lines(library):
    """``-Xptxas -v``'s registers, spills and shared memory of each kernel
    of ``library`` this process built: {kernel: [lines]}."""
    import re
    from repro_torch.kernels import _build
    out, fn = {}, None
    for line in _build.BUILD_LOGS.get(library, "").splitlines():
        if "Compiling entry function" in line:
            # e.g. ..16flash_fwd_kernelIfLb1EE.. -> flash_fwd_kernel<f32,1>
            # and selective_scan_kernelIfLi16EEv.. -> <f32,16>
            m = re.search(r"\d+([a-z_]+_kernel)I(13__nv_bfloat16|f)"
                          r"((?:L[ib]\d+E)*)", line)
            fn = (f"{m[1]}<{'bf16' if m[2] != 'f' else 'f32'}"
                  + "".join("," + a for a in re.findall(r"L[ib](\d+)E",
                                                         m[3])) + ">"
                  if m else line.split("'")[1])
        elif fn and ("registers" in line or "spill" in line):
            out.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return out


def sass_loop(so, kernel, per_iter):
    """The SASS (``cuobjdump -sass``) of the steady-state loop of the
    kernel whose mangled name matches the regex ``kernel`` in the library
    ``so`` (the loop with the fewest branches inside, then the longest):
    its instructions by opcode and their count per unit of work, where one
    iteration does ``per_iter`` units. None if cuobjdump is missing."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=120, check=False)
    funcs = [f for f in res.stdout.split("Function : ")[1:]
             if re.match(kernel, f.split(None, 1)[0])]
    check(len(funcs) == 1, f"SASS: {len(funcs)} functions match {kernel}")
    ins = [(int(m[1], 16), m[2], m[3]) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", funcs[0])]
    loops = [(int(t, 16), a) for a, op, args in ins
             if op.startswith("BRA")
             for t in re.findall(r"0x([0-9a-f]+)", args) if int(t, 16) < a]
    check(bool(loops), f"SASS: no loop in {kernel}")
    bodies = [[op for a, op, _ in ins if lo <= a <= hi] for lo, hi in loops]
    body = min(bodies, key=lambda b: (sum(op.startswith("BRA") for op in b),
                                      -len(b)))
    by_op = {}
    for op in body:
        by_op[op] = by_op.get(op, 0) + 1
    return {"loop_instructions": len(body), "per_iter": per_iter,
            "per_unit": len(body) / per_iter,
            "by_opcode": dict(sorted(by_op.items(), key=lambda kv: -kv[1]))}


def attention_pairs(Sq, Sk, window):
    """(query, key) pairs K5's mask leaves visible (Sq <= Sk)."""
    off = Sk - Sq
    return sum(min(i + off + 1, window) if window else i + off + 1
               for i in range(Sq))


def cuda_ms(torch, fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    nvcc = run_cmd(["nvcc", "--version"] if shutil.which("nvcc")
                   else ["/usr/local/cuda/bin/nvcc", "--version"])
    say("device", name=name, capability=list(cap), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.splitlines()[-1] if nvcc else nvcc, triton=triton_v,
        count=torch.cuda.device_count())
    check(tuple(cap) == (9, 0), f"capability {cap} is not Hopper (9, 0)")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    names = tuple(_build.API)
    with ThreadPoolExecutor(len(names)) as ex:
        paths = list(ex.map(_build.build, names))
    for name, path in zip(names, paths):
        _build.load(name)
        log = _build.BUILD_LOGS.get(name, "(already built)")
        say("build", name=name, library=str(path.relative_to(ROOT)),
            ptxas=[ln for ln in log.splitlines() if "registers" in ln
                   or "spill" in ln or "smem" in ln])
    say("build", seconds=round(time.time() - t0, 3))


def _close(torch, got, want, tol, what, chunk=1 << 26):
    """``allclose`` (|got - want| <= atol + rtol |want|) and the max abs
    error, a chunk at a time: at full width one temporary of the whole
    (K, N_pad) buffer would not fit beside the buffers compared."""
    g, w = got.reshape(-1), want.reshape(-1)
    err, ok = 0.0, True
    for i in range(0, g.numel(), chunk):
        a, b = g[i:i + chunk].float(), w[i:i + chunk].float()
        d = (a - b).abs_()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= tol["atol"] + tol["rtol"] * b.abs()).all())
    check(ok, f"{what}: kernel disagrees with plain version (max abs err "
              f"{err}, tol {tol})")
    return err


def phase_kernels_small(torch, dev, errs):
    """Every kernel at small odd shapes, bits {8, 4, 1}."""
    from repro_torch.kernels import comm, quantize as qz, ref
    g = torch.Generator(device=dev).manual_seed(0)
    for bits in (8, 4, 1):
        tol = TOL8 if bits == 8 else TOL41
        for shape in [(1000, 37), (256,), (3 * 256 + 100,), (8, 8, 8)]:
            x = torch.randn(shape, generator=g, device=dev) * 5
            q_k, s_k, shp = qz.quantize_blockwise_fwd(x, bits=bits)
            q_p, s_p, _ = ref.quantize_blockwise_ref(x, bits=bits)
            nb = q_p.shape[0]
            check(torch.equal(q_k[:nb], q_p),
                  f"K1 packed codes differ at {shape} bits={bits}")
            e1 = _close(torch, s_k[:nb], s_p,
                        {"rtol": 1e-6, "atol": 0} if bits == 1
                        else {"rtol": 0, "atol": 0}, f"K1 scale {shape}")
            d_k = qz.dequantize_blockwise_fwd(q_p, s_p, shp, bits=bits)
            e2 = _close(torch, d_k, ref.dequantize_blockwise_ref(
                q_p, s_p, shp, bits=bits), {"rtol": 0, "atol": 0},
                f"K2 {shape}")
            errs["wire_quantize"] = max(errs["wire_quantize"], e1)
            errs["wire_dequantize"] = max(errs["wire_dequantize"], e2)
        for K, n in [(1, 8 * 256), (3, 16 * 256), (5, 8 * 256 + 300)]:
            buf = torch.randn((K, n), generator=g, device=dev) * 3
            res = torch.randn((K, n), generator=g, device=dev) * 0.1
            e3 = _close(torch, comm.quant_avg_dequant_fwd(buf, bits=bits),
                        ref.quant_avg_dequant_ref(buf, bits=bits), tol,
                        f"K3 ({K},{n}) bits={bits}")
            m_k, r_k = comm.quant_avg_dequant_ef_fwd(buf, res.clone(),
                                                     bits=bits)
            m_p, r_p = ref.quant_avg_dequant_ef_ref(buf, res.clone(),
                                                    bits=bits)
            e4 = max(_close(torch, m_k, m_p, tol, f"K4 mean ({K},{n})"),
                     _close(torch, r_k, r_p, tol, f"K4 residual ({K},{n})"))
            m0, _ = comm.quant_avg_dequant_ef_fwd(buf, torch.zeros_like(buf),
                                                  bits=bits)
            check(torch.equal(m0, comm.quant_avg_dequant_fwd(buf, bits=bits)),
                  "K4 with a zero residual is not K3 bit for bit")
            errs["wire_quant_avg_dequant"] = max(
                errs["wire_quant_avg_dequant"], e3)
            errs["wire_quant_avg_dequant_ef"] = max(
                errs["wire_quant_avg_dequant_ef"], e4)
    torch.cuda.synchronize()
    say("kernels-small", max_abs_err=errs)


def _fa_inputs(torch, dev, g, shape, dtype):
    B, Sq, Sk, H, KV, hd, hd_v, _ = shape
    return (torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype),
            torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype),
            torch.randn((B, Sk, KV, hd_v), generator=g, device=dev).to(dtype))


def phase_flash_small(torch, dev, errs):
    """K5 at small odd shapes, f32 and bf16, against its plain version.
    The kernels line carries the f32 error (the serving path's dtype)."""
    from repro_torch.kernels import flash_attention as fa, ref
    g = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = {"rtol": FA_TOL[dname], "atol": FA_TOL[dname]}
        for shape in FA_SMALL:
            q, k, v = _fa_inputs(torch, dev, g, shape, dtype)
            kw = {"n_kv_heads": shape[4], "window": shape[7]}
            got = fa.flash_attention_fwd(q, k, v, **kw)
            check(got.dtype == dtype and got.shape == (*shape[:2], shape[3],
                                                       shape[6]),
                  f"K5 output {got.dtype} {tuple(got.shape)} at {shape}")
            err = _close(torch, got, ref.flash_attention_ref(q, k, v, **kw),
                         tol, f"K5 {shape} {dname}")
            worst[dname] = max(worst.get(dname, 0.0), err)
    torch.cuda.synchronize()
    errs["flash_attention"] = max(errs["flash_attention"], worst["float32"])
    say("kernels-small", kernel="flash_attention", shapes=FA_SMALL,
        max_abs_err=worst, tol=FA_TOL)


def phase_flash_full(torch, dev, errs, name, bw, shape, seed):
    """K5 at a serving path's shape (``FA_PATH``, ``FA_PATH_JAMBA``),
    f32: against the plain version, timed beside it and beside the library
    call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    B, Sq, Sk, H, KV, hd, hd_v, window = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = _fa_inputs(torch, dev, g, shape, torch.float32)
    kw = {"n_kv_heads": KV, "window": window}
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = fa.flash_attention_fwd(q, k, v, **kw)
    err = _close(torch, got, want, {"rtol": FA_TOL["float32"],
                                    "atol": FA_TOL["float32"]},
                 f"K5 at {shape}")
    del want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    lib_err = float((lib_out.transpose(1, 2) - got).abs().max())
    del lib_out, got
    ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw))
    plain = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw))
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = attention_pairs(Sq, Sk, window)
    flops = 2 * B * H * pairs * (hd + hd_v)
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + B * Sq * H * hd_v)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    out = {"shape": list(shape), "dtype": "float32", "ms": ms,
           "plain_ms": plain, "library_ms": lib, "flops": flops,
           "bytes": nbytes, **tc_bound(name, bw, flops, nbytes, flops),
           "tflops": flops / ms / 1e9, "library_max_abs_diff": lib_err,
           "ptxas": ptxas_lines("flash_attention")}
    say("kernels-full", kernel="flash_attention", **out, max_abs_err=err)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def _ml_inputs(torch, dev, g, shape, gates, dtype):
    """q, k, v in ``dtype``, f32 gates N(shift, 1) (``ML_GATES``)."""
    B, S, H, hd = shape
    ish, fsh, nonneg = ML_GATES[gates]
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device=dev)
               for _ in range(3))
    if nonneg:
        q, k = q.abs_(), k.abs_()
    ig = torch.randn((B, S, H), generator=g, device=dev) + ish
    fg = torch.randn((B, S, H), generator=g, device=dev) + fsh
    return q.to(dtype), k.to(dtype), v.to(dtype), ig, fg


def phase_mlstm_small(torch, dev, errs):
    """K7 at small odd shapes, f32 and bf16 q/k/v, f32 and bf16 gates, in
    three gate regimes, against its plain version at 2e-4. The kernels
    line carries the f32 error (the serving path's dtype)."""
    from repro_torch.kernels import mlstm as ml, ref
    g = torch.Generator(device=dev).manual_seed(6)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in ML_SMALL:
            for gates in ML_GATES:
                q, k, v, ig, fg = _ml_inputs(torch, dev, g, shape, gates,
                                             dtype)
                for gdt in (torch.float32, torch.bfloat16):
                    a, b = ig.to(gdt), fg.to(gdt)
                    got = ml.mlstm_fwd(q, k, v, a, b)
                    check(got.dtype == torch.float32
                          and got.shape == tuple(shape),
                          f"K7 output {got.dtype} {tuple(got.shape)} at "
                          f"{shape}")
                    want, _ = ref.mlstm_ref(q, k, v, a, b)
                    err = _close(torch, got, want, ML_TOL,
                                 f"K7 {shape} {gates} {dname}")
                    worst[dname] = max(worst.get(dname, 0.0), err)
    torch.cuda.synchronize()
    errs["mlstm"] = max(errs["mlstm"], worst["float32"])
    say("kernels-small", kernel="mlstm", shapes=ML_SMALL,
        gates=list(ML_GATES), max_abs_err=worst, tol=ML_TOL)


def phase_mlstm_full(torch, dev, errs, name, bw):
    """K7 at the serving path's shape, f32, standard gates: against the
    plain version, timed beside it. No PyTorch call computes the
    recurrence, so there is no library time."""
    from repro_torch.kernels import mlstm as ml, ref
    B, S, H, hd = ML_PATH
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, ig, fg = _ml_inputs(torch, dev, g, ML_PATH, "standard",
                                 torch.float32)
    want, _ = ref.mlstm_ref(q, k, v, ig, fg)
    got = ml.mlstm_fwd(q, k, v, ig, fg)
    err = _close(torch, got, want, ML_TOL, f"K7 at {ML_PATH}")
    del want, got
    ms = cuda_ms(torch, lambda: ml.mlstm_fwd(q, k, v, ig, fg))
    plain = cuda_ms(torch, lambda: ref.mlstm_ref(q, k, v, ig, fg), reps=3,
                    warmup=1)
    # the least work: the state update and the read-out, 2 hd^2 flop each
    # per step (the chunkwise count as the chunk tends to 0); the CUDA-core
    # bound counted the stepwise form's 5 hd^2 (an extra multiply per
    # element of C)
    flops = 4 * hd * hd * B * H * S
    nbytes = 4 * (4 * B * S * H * hd + 2 * B * S * H)
    errs["mlstm"] = max(errs["mlstm"], err)
    torch.cuda.reset_peak_memory_stats()
    passes = device_ms_by_kernel(torch, lambda: ml.mlstm_fwd(q, k, v, ig, fg),
                                 ("gates_kernel", "states_kernel",
                                  "intra_kernel", "out_kernel"))
    peak = torch.cuda.max_memory_allocated()
    out = {"shape": list(ML_PATH), "dtype": "float32", "ms": ms,
           "plain_ms": plain, "library_ms": None, "flops": flops,
           "bytes": nbytes,
           **tc_bound(name, bw, flops, nbytes, 5 * hd * hd * B * H * S),
           "tflops": flops / ms / 1e9,
           "scratch_GB": 4 * ml.scratch_floats(B, S, H, hd) / 1e9,
           "passes_ms": passes,
           "peak_mem_GB": peak / 1e9, "ptxas": ptxas_lines("mlstm")}
    say("kernels-full", kernel="mlstm", **out, max_abs_err=err)
    del q, k, v, ig, fg
    torch.cuda.empty_cache()
    return out


def device_ms_by_kernel(torch, fn, names, reps=5):
    """Mean device milliseconds per call of ``fn`` spent in each kernel
    whose name contains one of ``names`` (``torch.profiler``), or None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = t if t is not None else getattr(e, "cuda_time_total", 0)
        for n in names:
            if n in e.key and t:
                out[n] = (out[n] or 0.0) + t / 1e3 / reps
    return out


def sm_clock_hz():
    """The card's maximum SM clock as ``nvidia-smi`` reports it, or None."""
    out = run_cmd(["nvidia-smi", "--query-gpu=clocks.max.sm",
                   "--format=csv,noheader,nounits"])
    try:
        return float(out.splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return None


def _ss_inputs(torch, dev, g, shape, x_dtype, regime="jax"):
    """K6's inputs: xc, Bm, Cm ~ N(0, 1), D = 1, and dt, A by ``regime``:
    "jax" as tests/test_kernels.py draws them (dt = softplus(N(0, 1)) *
    0.1, A = -exp(0.3 N(0, 1))); "mamba_init" as models/mamba.py
    initialises a layer (A = -[1..st], dt = softplus(N(0, 1) - 4.6));
    "strong" decay (A = -[1..st], dt ~ U(0, 3)). xc in ``x_dtype``, the
    rest f32."""
    import torch.nn.functional as F
    B, S, di, st = shape
    xc = torch.randn((B, S, di), generator=g, device=dev)
    n = torch.randn((B, S, di), generator=g, device=dev)
    dt = {"jax": lambda: F.softplus(n) * 0.1,
          "mamba_init": lambda: F.softplus(n - 4.6),
          "strong": lambda: 3 * torch.rand((B, S, di), generator=g,
                                           device=dev)}[regime]()
    del n
    Bm = torch.randn((B, S, st), generator=g, device=dev)
    Cm = torch.randn((B, S, st), generator=g, device=dev)
    A = (-torch.exp(torch.randn((di, st), generator=g, device=dev) * 0.3)
         if regime == "jax" else
         -torch.arange(1, st + 1, dtype=torch.float32, device=dev)
         .expand(di, st).contiguous())
    return xc.to(x_dtype), dt, Bm, Cm, A, torch.ones(di, device=dev)


def phase_scan_small(torch, dev, errs):
    """K6 at small odd shapes, f32 and bf16 xc, in every regime of dt and
    A, against its plain version at 1e-5: y and the final state. The
    kernels line carries the f32 error (the serving path's dtype)."""
    from repro_torch.kernels import ref, selective_scan as ss
    g = torch.Generator(device=dev).manual_seed(10)
    worst = {}
    for regime in SS_REGIMES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for shape in SS_SMALL:
                B, S, di, st = shape
                xs = _ss_inputs(torch, dev, g, shape, dtype, regime)
                y, h = ss.selective_scan_fwd(*xs)
                check(y.dtype == h.dtype == torch.float32
                      and y.shape == (B, S, di) and h.shape == (B, di, st),
                      f"K6 outputs {y.dtype} {tuple(y.shape)}, {h.dtype} "
                      f"{tuple(h.shape)} at {shape}")
                wy, wh = ref.selective_scan_ref(*xs)
                what = f"{shape} {dname} {regime}"
                err = max(_close(torch, y, wy, SS_TOL, f"K6 y {what}"),
                          _close(torch, h, wh, SS_TOL, f"K6 h {what}"))
                key = f"{regime}/{dname}"
                worst[key] = max(worst.get(key, 0.0), err)
    torch.cuda.synchronize()
    errs["selective_scan"] = max(errs["selective_scan"],
                                 *(e for k, e in worst.items()
                                   if k.endswith("float32")))
    say("kernels-small", kernel="selective_scan", shapes=SS_SMALL,
        max_abs_err=worst, tol=SS_TOL)


def phase_decode_small(torch, dev, errs):
    """K8 at small shapes against its plain version (``DA_SMALL`` at every
    ``DA_POS``, then a wrapped sliding window)."""
    from repro_torch.kernels import decode_attention as da, ref
    g = torch.Generator(device=dev).manual_seed(17)
    worst = 0.0
    for B, S, H, KV, hd in DA_SMALL:
        q = torch.randn((B, 1, H, hd), generator=g, device=dev)
        k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev)
                for _ in range(2))
        for p, window in [(p, 0) for p in DA_POS] + [(3 * S + 5, S)]:
            pos = torch.tensor(p, dtype=torch.int32, device=dev)
            kw = {"window": window, "softmax_scale": hd ** -0.5}
            worst = max(worst, _close(
                torch, da.decode_attention_fwd(q, k, v, pos, **kw),
                ref.decode_attention_ref(q, k, v, pos, **kw), DA_TOL,
                f"K8 {(B, S, H, KV, hd)} pos {p} window {window}"))
    torch.cuda.synchronize()
    errs["decode_attention"] = max(errs["decode_attention"], worst)
    say("kernels-small", kernel="decode_attention", shapes=DA_SMALL,
        positions=DA_POS, max_abs_err=worst, tol=DA_TOL)


def cold_ms(torch, fn, reps=10, warmup=2):
    """``cuda_ms`` with the L2 cache refilled before each timed run (a 256
    MB read): in a decode step the other layers' weights pass through L2
    between two calls of one layer's attention."""
    flush = torch.zeros(1 << 26, dtype=torch.float32, device="cuda")

    def run():
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    for _ in range(warmup):
        run()
    return statistics.median(run() for _ in range(reps))


def phase_decode_full(torch, dev, errs, bw):
    """K8 at the decode cell's shape (``DA_PATH``) at ``DA_PATH_POS``,
    f32: against the plain version, timed (``cold_ms``) beside its byte bound
    (the valid K and V rows read once, q read and the output written once),
    the plain version (which repeats K and V over the whole cache) and the
    library yardstick ``F.scaled_dot_product_attention(enable_gqa=True)``
    over the valid slots, which the port never calls. Returns the record
    at the middle position, with every position under ``positions``."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da, ref
    B, S, H, KV, hd = DA_PATH
    g = torch.Generator(device=dev).manual_seed(19)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev)
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev)
            for _ in range(2))
    kw = {"window": 0, "softmax_scale": hd ** -0.5}
    rows, worst = [], 0.0
    for p in DA_PATH_POS:
        pos = torch.tensor(p, dtype=torch.int32, device=dev)
        got = da.decode_attention_fwd(q, k, v, pos, **kw)
        err = _close(torch, got, ref.decode_attention_ref(q, k, v, pos, **kw),
                     DA_TOL, f"K8 at {DA_PATH} pos {p}")
        worst = max(worst, err)
        qt = q.transpose(1, 2)
        kt, vt = (t[:, :p + 1].transpose(1, 2) for t in (k, v))
        lib_err = float((F.scaled_dot_product_attention(
            qt, kt, vt, scale=kw["softmax_scale"],
            enable_gqa=True).transpose(1, 2) - got).abs().max())
        ms = cold_ms(torch, lambda: da.decode_attention_fwd(q, k, v, pos,
                                                            **kw))
        plain = cold_ms(torch, lambda: ref.decode_attention_ref(q, k, v, pos,
                                                                **kw))
        lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=kw["softmax_scale"], enable_gqa=True))
        nbytes = 4 * (2 * B * (p + 1) * KV * hd + 2 * B * H * hd)
        flops = 4 * B * H * (p + 1) * hd
        bound = 1e3 * nbytes / bw
        rows.append({"pos": p, "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bytes": nbytes, "flops": flops,
                     "bound_ms": bound, "bound_by": "bytes",
                     "roofline_pct": 100 * bound / ms,
                     "GB_per_s": nbytes / ms / 1e6, "max_abs_err": err,
                     "library_max_abs_diff": lib_err})
    errs["decode_attention"] = max(errs["decode_attention"], worst)
    mid = {k: x for k, x in rows[len(rows) // 2].items()
           if k != "max_abs_err"}
    out = {"shape": list(DA_PATH), "dtype": "float32", **mid,
           "positions": rows,
           "ptxas": ptxas_lines("decode_attention")}
    say("kernels-full", kernel="decode_attention", **out, max_abs_err=worst)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def scan_chunk(src=ROOT / SCAN_SRC):
    """K6's steps a staged chunk (``CH``) as its source sets them."""
    import re
    return int(re.search(r"\bCH = (\d+);", Path(src).read_text())[1])


def phase_scan_full(torch, dev, errs, name, bw):
    """K6 at the serving path's shape, f32: against the plain version
    (y and the final state), timed beside it. No PyTorch call computes the
    scan, so there is no library time."""
    from repro_torch.kernels import _build, ref, selective_scan as ss
    B, S, di, st = SS_PATH
    g = torch.Generator(device=dev).manual_seed(11)
    regime_errs = {}
    for regime in SS_REGIMES[::-1]:     # the JAX suite's draw is timed
        xs = _ss_inputs(torch, dev, g, SS_PATH, torch.float32, regime)
        wy, wh = ref.selective_scan_ref(*xs)
        y, h = ss.selective_scan_fwd(*xs)
        regime_errs[regime] = max(
            _close(torch, y, wy, SS_TOL, f"K6 y at {SS_PATH} {regime}"),
            _close(torch, h, wh, SS_TOL, f"K6 h at {SS_PATH} {regime}"))
        del wy, wh, y, h
    err = max(regime_errs.values())
    ms = cuda_ms(torch, lambda: ss.selective_scan_fwd(*xs))
    plain = cuda_ms(torch, lambda: ref.selective_scan_ref(*xs), reps=3,
                    warmup=1)
    n = B * S * di
    # per state update: dt*A, the exp, dt*B*x (two products), one FMA into
    # h and one into y; per output the D*x product and its add
    flops = 8 * n * st + 2 * n
    nbytes = (sum(t.numel() * t.element_size() for t in xs)
              + 4 * n + 4 * B * di * st)
    t_ops, t_bytes = 1e3 * flops / f32_peak(name), 1e3 * nbytes / bw
    clock = sm_clock_hz()
    ch = scan_chunk()
    sass = sass_loop(_build.lib_path("selective_scan"),
                     r".*selective_scan_kernelIfLi16E", ch * st)
    errs["selective_scan"] = max(errs["selective_scan"], err)
    out = {"shape": list(SS_PATH), "dtype": "float32", "ms": ms,
           "plain_ms": plain, "library_ms": None, "flops": flops,
           "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "GB_per_s": nbytes / ms / 1e6,
           # every exp on the SFU, 16 per SM per clock (132 SMs)
           "sfu_exp_ms": (1e3 * n * st / (16 * 132 * clock) if clock
                          else None), "sm_clock_max_hz": clock,
           "steps_per_chunk": ch, "max_abs_err_by_regime": regime_errs,
           "ptxas": ptxas_lines("selective_scan"),
           "sass_per_state_update": sass,
           # MUFU.EX2 per state update in the chunk loop: the share of the
           # exps on the SFU (the rest would be on the FMA pipe)
           "sfu_exp_share": (sass["by_opcode"].get("MUFU.EX2", 0)
                             / sass["per_iter"] if sass else None)}
    say("kernels-full", kernel="selective_scan", **out, max_abs_err=err)
    del xs
    torch.cuda.empty_cache()
    return out


def full_cfg():
    from repro_torch.configs import get_config
    return get_config("internlm2-1.8b").with_(
        n_layers=LAYERS, segments=((("gqa:dense",), LAYERS),))


def phase_kernels_full(torch, dev, errs, bw):
    """Each kernel at the shapes the main path gives it; times and bounds."""
    from repro_torch.core import flatbuf
    from repro_torch.kernels import comm, quantize as qz, ref
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves_with_path, unflatten_like
    # the main path's tree as shapes only (meta tensors hold no memory),
    # read off a one-layer model: the layer leaves' leading dim is the
    # depth, and the leaf order does not depend on it
    cfg1 = full_cfg().with_(n_layers=1, segments=((("gqa:dense",), 1),))
    one = tr.init_params(0, cfg1, torch.float32, device=dev)
    shapes = [((LAYERS, *t.shape[1:]) if path.startswith("segments/")
               else tuple(t.shape)) for path, t in leaves_with_path(one)]
    meta = unflatten_like(one, [torch.empty((5, *s), device="meta")
                                for s in shapes])
    del one
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}

    # K3 at (5, N_pad), K4 at (3, N_pad): the flat layout of the K-stacked
    # tree (N_pad is per participant, independent of K)
    n_pad = flatbuf.make_layout(meta).n_pad
    say("kernels-full", n_pad=n_pad, leaves=len(shapes))
    for name, K, bits in (("wire_quant_avg_dequant", 5, 8),
                          ("wire_quant_avg_dequant_ef", 3, 4)):
        buf = torch.randn((K, n_pad), generator=g, device=dev)
        tol = TOL8 if bits == 8 else TOL41
        if name == "wire_quant_avg_dequant":
            want = ref.quant_avg_dequant_ref(buf, bits=bits)  # temps first
            got = comm.quant_avg_dequant_fwd(buf, bits=bits)
            err = _close(torch, got, want, tol, f"K3 at ({K}, N_pad)")
            del got, want
            ms = cuda_ms(torch, lambda: comm.quant_avg_dequant_fwd(
                buf, bits=bits))
            plain = cuda_ms(torch, lambda: ref.quant_avg_dequant_ref(
                buf, bits=bits))
            nbytes = 4 * K * n_pad + 4 * n_pad
        else:
            # both update the residual in place; at (3, N_pad) one residual
            # is 16.6 GB, so the second copy is drawn again from the same
            # seed after the plain version's temporaries are gone
            def residual():
                r = torch.Generator(device=dev).manual_seed(2)
                return torch.randn((K, n_pad), generator=r, device=dev) * .01
            m_p, r_p = ref.quant_avg_dequant_ef_ref(buf, residual(),
                                                    bits=bits)
            m_k, r_k = comm.quant_avg_dequant_ef_fwd(buf, residual(),
                                                     bits=bits)
            err = max(_close(torch, m_k, m_p, tol, "K4 mean at (3, N_pad)"),
                      _close(torch, r_k, r_p, tol,
                             "K4 residual at (3, N_pad)"))
            del m_k, m_p, r_p
            ms = cuda_ms(torch, lambda: comm.quant_avg_dequant_ef_fwd(
                buf, r_k, bits=bits))
            plain = cuda_ms(torch, lambda: ref.quant_avg_dequant_ef_ref(
                buf, r_k, bits=bits))
            nbytes = 8 * K * n_pad + 4 * n_pad + 4 * K * n_pad
            del r_k
        del buf
        torch.cuda.empty_cache()
        out[name] = {"shape": [K, n_pad], "bits": bits, "ms": ms,
                     "plain_ms": plain, "bytes": nbytes,
                     "bound_ms": 1e3 * nbytes / bw, "bound_by": "bytes"}
        errs[name] = max(errs[name], err)
        say("kernels-full", kernel=name, **out[name], max_abs_err=err)

    # K1 / K2 over the leaves of the K=3 stacked tree (leafwise codec)
    xs = [torch.randn((3, *s), generator=g, device=dev) for s in shapes]
    payload = []
    e1 = e2 = 0.0
    for x in xs:
        q_k, s_k, shp = qz.quantize_blockwise_fwd(x, bits=8)
        q_p, s_p, _ = ref.quantize_blockwise_ref(x, bits=8)
        nb = q_p.shape[0]
        check(torch.equal(q_k[:nb], q_p), f"K1 codes differ at {shp}")
        e1 = max(e1, _close(torch, s_k[:nb], s_p, {"rtol": 0, "atol": 0},
                            f"K1 scale at {shp}"))
        d_k = qz.dequantize_blockwise_fwd(q_k, s_k, shp, bits=8)
        d_p = ref.dequantize_blockwise_ref(q_k, s_k, shp, bits=8)
        e2 = max(e2, _close(torch, d_k, d_p, {"rtol": 0, "atol": 0},
                            f"K2 at {shp}"))
        del q_p, s_p, d_k, d_p
        payload.append((q_k, s_k, shp))
    torch.cuda.empty_cache()
    errs["wire_quantize"] = max(errs["wire_quantize"], e1)
    errs["wire_dequantize"] = max(errs["wire_dequantize"], e2)
    n_el = sum(x.numel() for x in xs)
    rows = sum(q.shape[0] for q, _, _ in payload)
    for name, kern, plain_fn, nbytes in (
            ("wire_quantize",
             lambda: [qz.quantize_blockwise_fwd(x, bits=8) for x in xs],
             lambda: [ref.quantize_blockwise_ref(x, bits=8) for x in xs],
             4 * n_el + rows * 256 + 4 * rows),
            ("wire_dequantize",
             lambda: [qz.dequantize_blockwise_fwd(q, s, shp, bits=8)
                      for q, s, shp in payload],
             lambda: [ref.dequantize_blockwise_ref(q, s, shp, bits=8)
                      for q, s, shp in payload],
             rows * 256 + 4 * rows + 4 * n_el)):
        ms = cuda_ms(torch, kern)
        plain = cuda_ms(torch, plain_fn)
        out[name] = {"shape": f"{len(xs)} leaves of the K=3 stacked tree, "
                              f"{n_el} values", "bits": 8, "ms": ms,
                     "plain_ms": plain, "bytes": nbytes,
                     "bound_ms": 1e3 * nbytes / bw, "bound_by": "bytes"}
        say("kernels-full", kernel=name, **out[name],
            max_abs_err=errs[name])
    del payload

    # K1 / K2 once each over the flat (3, N_pad) buffer of the same tree:
    # the fused codec's standalone roundtrip (partial participation, phase
    # 9(b)), held bit for bit against the plain versions a block range at
    # a time (their temporaries at 4.2e9 values would not fit)
    tree = unflatten_like(meta, xs)
    flat = flatbuf.flatten(tree, flatbuf.make_layout(tree))
    del tree, xs
    torch.cuda.empty_cache()
    q_k, s_k, shp = qz.quantize_blockwise_fwd(flat, bits=8)
    d_k = qz.dequantize_blockwise_fwd(q_k, s_k, shp, bits=8)
    xf, df = flat.reshape(-1), d_k.reshape(-1)
    nb, step = xf.numel() // 256, 1 << 18
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        q_p, s_p, _ = ref.quantize_blockwise_ref(xf[b0 * 256:b1 * 256],
                                                 bits=8)
        check(torch.equal(q_k[b0:b1], q_p) and torch.equal(s_k[b0:b1], s_p),
              f"K1 over the flat (3, N_pad) buffer differs in blocks "
              f"{b0}-{b1}")
        d_p = ref.dequantize_blockwise_ref(q_k[b0:b1], s_k[b0:b1],
                                           ((b1 - b0) * 256,), bits=8)
        check(torch.equal(df[b0 * 256:b1 * 256], d_p),
              f"K2 over the flat (3, N_pad) buffer differs in blocks "
              f"{b0}-{b1}")
        del q_p, s_p, d_p
    del d_k, df
    torch.cuda.empty_cache()
    n_el = xf.numel()
    for name, kern, nbytes in (
            ("wire_quantize",
             lambda: qz.quantize_blockwise_fwd(flat, bits=8),
             4 * n_el + nb * 256 + 4 * nb),
            ("wire_dequantize",
             lambda: qz.dequantize_blockwise_fwd(q_k, s_k, shp, bits=8),
             nb * 256 + 4 * nb + 4 * n_el)):
        out[name]["flat"] = {
            "shape": list(flat.shape), "bits": 8, "bit_exact": True,
            "ms": cuda_ms(torch, kern), "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / bw, "bound_by": "bytes"}
        say("kernels-full", kernel=name, flat=out[name]["flat"])
    del flat, xf, q_k, s_k
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
def _learner(torch, cfg, codec, K, dev, engine="fused", eta0=0.05,
             rounds=2, rule="ile", remat=True, **kw):
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core.colearn import CoLearner
    from repro_torch.launch.train import make_loss_fn
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=eta0, epsilon=0.05,
                         epochs_rule=rule, max_rounds=rounds)
    return CoLearner(ccfg, make_loss_fn(cfg, remat=remat), codec=codec,
                     round_engine=engine, device=dev, **kw)


def phase_small_round(torch, dev):
    """Smoke config, K=3, 3 rounds of the fused engine (fused codec): the
    card's captured rounds (one capture, two replays) against the same
    rounds run uncaptured on the CPU, each round's window under the sync
    guard."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import api, flatbuf
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import build_data, epoch_batches_fn
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = get_smoke_config("internlm2-1.8b")
    K, rounds = 3, 3
    data = build_data(cfg, K, 4, 16, 48, seed=0)
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    runs = {}
    for d in ("cpu", dev):
        learner = _learner(torch, cfg, api.get_codec("fused"), K, d,
                           rounds=rounds, rule="fle")
        runner = learner._runner
        captured, guard = runner._round, []

        def round_graph(*a, _captured=captured, _guard=guard):
            _guard.append(torch.cuda.get_sync_debug_mode())
            return _captured(*a)
        runner._round = round_graph
        state = learner.init(params)
        ops.reset_launch_counts()
        for _ in range(rounds):
            state = learner.run_round(state, epoch_batches_fn(data, d, 2))
        runs[str(d)] = (state, ops.launch_counts(), captured, guard)
    (cs, c_counts, _, _), (gs, g_counts, graph, guard) = (runs["cpu"],
                                                         runs[str(dev)])
    check(c_counts["wire_quant_avg_dequant"] == 0, "CPU run launched K3")
    check(g_counts["wire_quant_avg_dequant"] == rounds,
          f"card run launched K3 {g_counts['wire_quant_avg_dequant']} "
          "times, not once per round")
    check((graph.captures, graph.replays) == (1, rounds - 1),
          f"round graph captured {graph.captures} times and replayed "
          f"{graph.replays} in {rounds} rounds at one T")
    check(guard == [2] * rounds,
          f"round windows ran at sync debug modes {guard}, not 'error'")
    worst = 0.0
    for a, b in zip(cs["log"], gs["log"]):
        check(a.T == b.T and a.comm_bytes == b.comm_bytes,
              "round logs disagree on T / comm bytes")
        for x, y in [*zip(a.local_losses, b.local_losses),
                     (a.lr_first, b.lr_first), (a.rel_change, b.rel_change)]:
            if math.isinf(x):
                check(math.isinf(y), "rel_change inf on one side only")
                continue
            rel = abs(x - y) / max(abs(x), 1e-12)
            worst = max(worst, rel)
    check(worst <= 1e-4, f"card vs CPU round logs differ by {worst} (rel)")
    buf = flatbuf.flatten(cs["params"], flatbuf.make_layout(cs["params"]))
    live = buf.reshape(-1, 256).abs().amax(1) > 0       # not zero padding
    quantum = float(ref.quantize_blockwise_ref(buf)[1][live].max()) / K
    pdiff = max(float((a - b.cpu()).abs().max())
                for a, b in zip(leaves(cs["params"]), leaves(gs["params"])))
    check(pdiff <= quantum, f"card vs CPU params differ by {pdiff} > one "
                            f"wire quantum {quantum}")
    say("small-round", engine="fused", rounds=rounds, K=K,
        log_max_rel_diff=worst, param_max_abs_diff=pdiff,
        wire_quantum=quantum, card_launches=g_counts,
        captures=graph.captures, replays=graph.replays,
        window_sync_debug_modes=guard,
        losses_card=[round(float(sum(l.local_losses) / len(l.local_losses)),
                           6) for l in gs["log"]])


# phase 4's gated run: the smoke model's divergences (0.0068-0.0105 on the
# CPU) are >= 17% away from it
SMALL_GATE_DELTA = 0.0088


def _record_gate(learner):
    """Wrap the fused runner's gate graph: each call's divergence, cloned
    on the device (no host sync inside the round's window)."""
    runner = learner._runner
    gate, divs = runner._gate, []

    def recorded(*a):
        out = gate(*a)
        divs.append(out[0].clone())
        return out
    runner._gate = recorded
    return gate, divs


def phase_small_strategies(torch, dev):
    """Phase 4's strategy runs (smoke config, K=3, fused engine), each on
    the card (captured) against the same rounds uncaptured on the CPU at
    1e-4 with equal sync patterns and comm bytes: (a) the divergence
    trigger under fused int4 with error feedback (K4 only on synced
    rounds; the residual unchanged across every quiet round); (b) partial
    participation, m=2, over the fused int8 codec's flat roundtrip (K1 and
    K2 once a round); (c) ragged shards of 3, 2 and 1 batches under their
    mask (K3 once a round)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (build_data, epoch_batches_fn,
                                          make_loss_fn)
    from repro_torch.models import transformer as tr
    cfg = get_smoke_config("internlm2-1.8b")
    K = 3
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    iid = build_data(cfg, K, 4, 16, 48, seed=0)
    ragged = build_data(cfg, K, 4, 16, 24, seed=0, partition="sizes",
                        sizes=[12, 8, 4])
    check(ragged.batch_mask.sum(1).tolist() == [3, 2, 1],
          f"ragged shards hold {ragged.batch_counts} batches")
    fused = api.get_codec("fused")
    cases = {
        "gated": (iid, 2, 4, api.get_codec("fused", bits=4,
                                           error_feedback=True),
                  {"sync_policy": api.DivergenceTrigger(
                      delta=SMALL_GATE_DELTA)}),
        "partial": (iid, 2, 3, fused,
                    {"aggregator": api.PartialParticipation(m=2),
                     "shard_sizes": iid.sizes}),
        "ragged": (ragged, 3, 3, fused,
                   {"batch_mask": ragged.batch_mask,
                    "shard_sizes": ragged.sizes})}
    for label, (data, steps, rounds, codec, kw) in cases.items():
        runs = {}
        for d in ("cpu", dev):
            ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05,
                                 epochs_rule="fle", max_rounds=rounds)
            learner = CoLearner(ccfg, make_loss_fn(cfg), codec=codec,
                                round_engine="fused", device=d, **kw)
            gate, divs = _record_gate(learner)
            state = learner.init(params)
            batches = epoch_batches_fn(data, d, steps)
            kept = []
            ops.reset_launch_counts()
            for _ in range(rounds):
                res = (state["residual"].clone()
                       if state["residual"] is not None else None)
                state = learner.run_round(state, batches)
                if res is not None and not state["log"][-1].synced:
                    kept.append(bool(torch.equal(res, state["residual"])))
            counts = ops.launch_counts()
            graphs = {f.name: (f.captures, f.replays)
                      for f in learner._runner.graphs.functions}
            runs[str(d)] = (state["log"], counts, graphs, kept,
                            [float(x) for x in divs])
            del learner, state, gate
            gc.collect()
        (clog, ccounts, _, _, cdivs), (glog, gcounts, graphs, kept,
                                      gdivs) = runs["cpu"], runs[str(dev)]
        check(not any(ccounts.values()), f"4 {label}: the CPU run launched "
                                         f"{ccounts}")
        synced = [x.synced for x in glog]
        check(synced == [x.synced for x in clog]
              and [x.comm_bytes for x in glog] == [x.comm_bytes
                                                    for x in clog]
              and [x.T for x in glog] == [x.T for x in clog],
              f"4 {label}: card and CPU differ in sync pattern, T or bytes")
        worst = 0.0
        for a, b in zip(clog, glog):
            for x, y in [*zip(a.local_losses, b.local_losses),
                         (a.rel_change, b.rel_change)]:
                if math.isinf(x):
                    check(math.isinf(y), "rel_change inf on one side only")
                    continue
                worst = max(worst, abs(x - y) / max(abs(x), 1e-12))
        check(worst <= 1e-4, f"4 {label}: card vs CPU logs differ by "
                             f"{worst} (rel)")
        n_sync = sum(synced)
        if label == "gated":
            margin = min(abs(v - SMALL_GATE_DELTA) / SMALL_GATE_DELTA
                         for v in cdivs + gdivs)
            check(margin > 0.05, f"4 gated: a divergence within "
                                 f"{margin:.1%} of delta")
            check(0 < n_sync < rounds, f"4 gated: pattern {synced}")
            check(gcounts["wire_quant_avg_dequant_ef"] == n_sync,
                  f"4 gated: K4 launched {gcounts} for {n_sync} syncs")
            check(kept and all(kept), f"4 gated: the residual moved on a "
                                      f"quiet round ({kept})")
            check(graphs["gate"] == (1, rounds)
                  and graphs["finalize"] == (1, n_sync),
                  f"4 gated: graphs {graphs}")
            check(all(x.comm_bytes == 0 for x in glog if not x.synced),
                  "4 gated: a quiet round billed bytes")
        elif label == "partial":
            check(gcounts["wire_quantize"] == gcounts["wire_dequantize"]
                  == rounds, f"4 partial: K1/K2 launched {gcounts}")
        else:
            check(gcounts["wire_quant_avg_dequant"] == rounds,
                  f"4 ragged: K3 launched {gcounts}")
            check(graphs["round"] == (1, rounds - 1),
                  f"4 ragged: graphs {graphs}")
        say("small-strategies", run=label, rounds=rounds, K=K,
            synced=synced, comm_bytes=[x.comm_bytes for x in glog],
            log_max_rel_diff=worst, card_launches=gcounts, graphs=graphs,
            divergences_card=gdivs, divergences_cpu=cdivs,
            residual_kept_on_quiet_rounds=kept,
            losses_card=[float(sum(x.local_losses) / len(x.local_losses))
                         for x in glog])


# phase 4's membership runs (smoke config): K = 3 plus one standby slot;
# slot 1 crashes at round 1 and rejoins at round 3, the standby joins at
# round 2
SMALL_CHURN = (("crash", 1, 1), ("rejoin", 3, 1), ("rejoin", 2, 3))


def _watch_membership(torch, learner, report):
    """Wrap the learner's runner so that each round, at its entry (after
    the membership step and the restarts) and at its end, records into
    ``report``: whether every slot that joined this round holds exactly
    the sync reference (``prev_avg``), and copies of the dead rows, whose
    params, optimizer state and round state must come out of the round
    bit for bit; and, on the fused engine, the sync debug mode each round
    graph replays under."""
    from repro_torch.tree import leaves
    runner = learner._runner
    run = runner.run_round

    def rows(state, k):
        return [t[k].clone() for key in ("params", "opt", "residual")
                for t in leaves(state.get(key))]

    def watched(state, batches):
        mem, i = state["membership"], state["round"]
        ref = state["prev_avg"]
        joined = mem.joined(i)
        report.setdefault("rejoin_equals_prev_avg", []).extend(
            all(torch.equal(t[k], r) for t, r in
                zip(leaves(state["params"]), leaves(ref)))
            for k in joined if ref is not None)
        dead = [k for k, a in enumerate(mem.live) if not a]
        before = {k: rows(state, k) for k in dead}
        state = run(state, batches)
        report.setdefault("dead_rows_unchanged", []).extend(
            all(torch.equal(a, b) for a, b in zip(before[k], rows(state, k)))
            for k in dead)
        report.setdefault("captures_after_round", []).append(
            runner.graphs.captures if hasattr(runner, "graphs") else None)
        return state
    runner.run_round = watched
    if hasattr(runner, "_round"):
        graph, guard = runner._round, report.setdefault("guard", [])

        def round_graph(*a):
            guard.append(torch.cuda.get_sync_debug_mode())
            return graph(*a)
        runner._round = round_graph


_HOST_KEYS = ("membership", "ctrl", "round", "global_epoch")
_TENSOR_KEYS = ("params", "opt", "residual", "prev_avg")


def _snapshot(state):
    """A CPU copy of a round state (its tensors and its host fields)."""
    from repro_torch.tree import tree_map
    snap = {k: state[k] for k in _HOST_KEYS}
    for k in _TENSOR_KEYS:
        snap[k] = tree_map(lambda t: t.detach().cpu().clone(), state.get(k))
    return snap


def _load_snapshot(torch, state, snap):
    """Write a snapshot into a CPU learner's state, in place."""
    from repro_torch.tree import leaves, tree_map
    for k in _HOST_KEYS:
        state[k] = snap[k]
    for k in _TENSOR_KEYS:
        if snap[k] is None or state.get(k) is None:
            state[k] = tree_map(torch.clone, snap[k])
        else:
            for dst, src in zip(leaves(state[k]), leaves(snap[k])):
                dst.copy_(src)


def _record_aggregate(torch, learner, state, paths=None):
    """Wrap the learner's aggregate so that it copies its inputs (the
    post-epoch params and the round state, as the tree ``(params,
    state)``) into buffers allocated here, outside any capture, and
    rebind the engine. ``paths``: record only these leaves (``"0/..."``
    params, ``"1/..."`` round state). Returns the buffers by path."""
    from repro_torch.tree import leaves_with_path
    bufs = {p: torch.empty_like(t) for p, t in leaves_with_path(
        (state["params"], state["residual"])) if paths is None or p in paths}
    agg = learner._aggregate_fn

    def recording(stacked, weights, *rest, **kw):
        with torch.no_grad():
            for p, t in leaves_with_path((stacked, *rest)):
                if p in bufs:
                    bufs[p].copy_(t)
        return agg(stacked, weights, *rest, **kw)
    learner._aggregate_fn = recording
    learner._runner = None
    gc.collect()
    torch.cuda.empty_cache()
    learner._runner = learner.round_engine.bind(learner)
    return bufs


def _force_aggregate(torch, learner, inputs):
    """Wrap the (uncaptured) learner's aggregate so that each call first
    overwrites its inputs with the next of ``inputs`` (another run's
    recorded aggregate inputs, by path), and rebind the engine."""
    from repro_torch.tree import leaves_with_path
    agg, it = learner._aggregate_fn, iter(inputs)

    def forced(stacked, weights, *rest, **kw):
        src = next(it)
        with torch.no_grad():
            for p, t in leaves_with_path((stacked, *rest)):
                t.copy_(src[p])
        return agg(stacked, weights, *rest, **kw)
    learner._aggregate_fn = forced
    learner._runner = learner.round_engine.bind(learner)


def _small_member_run(torch, cfg, params, d, label, engine, rounds,
                      stop=None, restore=None, trace=None, follow=None):
    """One phase 4 membership run on ``d``: (i) FullAverage over the fused
    int8 codec, (ii) D² over the ring with the leafwise int4 codec and
    error feedback, both under ``SMALL_CHURN`` on K = 4 slots; (iii)
    GraphGossip over the exponential graph, K = 4, no churn. ``stop``:
    save the round state after that many rounds (returned with the run);
    ``restore``: a saved path restored into the fresh learner first;
    ``trace``: a list that receives, each round, its entry state
    (``_snapshot``) and its aggregate's inputs; ``follow``: such a list
    (another run's), loaded before each round and into each aggregate:
    each round then differs from the other run's only by its own f32
    order, with the same codes on the wire."""
    from repro_torch.checkpoint import io
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api, membership
    from repro_torch.core.colearn import CoLearner
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (build_data, epoch_batches_fn,
                                          make_loss_fn)
    K = 4
    if label == "gossip-exponential":
        data = build_data(cfg, K, 4, 16, 64, seed=0)
        kw = {"codec": api.get_codec("leafwise"),
              "aggregator": api.GraphGossip("exponential")}
    else:
        data = build_data(cfg, 3, 4, 16, 48, seed=0, k_max=K)
        kw = {"churn": membership.ScriptedChurn(events=SMALL_CHURN,
                                                initial_live=3)}
        if label == "churn":
            kw["codec"] = api.get_codec("fused")
        else:
            kw["codec"] = api.LeafwiseIntN(bits=4, error_feedback=True)
            kw["aggregator"] = api.D2Gossip("ring")
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05,
                         epochs_rule="fle", max_rounds=rounds)
    learner = CoLearner(ccfg, make_loss_fn(cfg), round_engine=engine,
                        device=d, **kw)
    report, matrices = {}, []
    state = learner.init(params)
    if trace is not None:
        bufs = _record_aggregate(torch, learner, state)
    if follow is not None:
        _force_aggregate(torch, learner, [x[1] for x in follow])
    _watch_membership(torch, learner, report)
    if restore is not None:
        state = io.restore_round_state(restore, state)
    batches = epoch_batches_fn(data, d, 2)
    saved = None
    ops.reset_launch_counts()
    while state["round"] < rounds:
        if trace is not None:
            entry = _snapshot(state)
        if follow is not None:
            _load_snapshot(torch, state, follow[state["round"]][0])
        state = learner.run_round(state, batches)
        if trace is not None:
            trace.append((entry, {p: b.cpu().clone()
                                  for p, b in bufs.items()}))
        if learner._weights_np is not None:
            matrices.append(learner._weights_np.copy())
        if stop is not None and state["round"] == stop:
            saved = str(ROOT / "build" / f"chip_smoke_ck_{label}")
            (ROOT / "build").mkdir(exist_ok=True)
            io.save_round_state(saved, state)
    report["launches"] = ops.launch_counts()
    return learner, state, report, matrices, saved


def _jitter(torch, params, g):
    """A copy of ``params`` with every value scaled by 1 + u, |u| <= 1e-7."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t * (1 + (torch.rand(
        t.shape, generator=g) - 0.5) * 2e-7), params)


def _logs_rel_diff(a, b):
    """Largest relative distance between two runs' losses and rel."""
    worst = 0.0
    for x, y in zip(a, b):
        for u, v in [*zip(x.local_losses, y.local_losses),
                     (x.rel_change, y.rel_change)]:
            if math.isinf(u):
                check(math.isinf(v), "rel_change inf on one side only")
                continue
            worst = max(worst, abs(u - v) / max(abs(u), 1e-12))
    return worst


def _bitwise_equal(torch, a, b):
    from repro_torch.tree import leaves
    return all(torch.equal(x, y) for key in ("params", "residual",
                                             "prev_avg", "opt")
               for x, y in zip(leaves(a[key]), leaves(b[key])))


def phase_small_membership(torch, dev):
    """Phase 4's membership runs, each card against CPU at 1e-4 with equal
    live counts, sync patterns and bills: (i) churn over FullAverage
    (fused int8), both engines on the card; (ii) D² over the ring under
    the same churn (leafwise int4 with error feedback); (iii) GraphGossip
    over the time-varying exponential graph; (iv) (ii) saved after round
    2, restored into a fresh learner and into (ii)'s own, rounds 3-4 bit
    for bit equal to the uninterrupted run, the second with no capture."""
    import numpy as np
    from repro_torch.checkpoint import io
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import build_data, epoch_batches_fn
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = get_smoke_config("internlm2-1.8b")
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    runs = {}
    for label, rounds in (("churn", 4), ("d2", 4),
                          ("gossip-exponential", 3)):
        trace = []
        card = _small_member_run(torch, cfg, params, dev, label, "fused",
                                 rounds, stop=2 if label == "d2" else None,
                                 trace=trace)
        runs[label] = card
        # each round from the card's entry state (the round's own f32
        # order only), and the whole run from the same init
        others = {"cpu-by-round": _small_member_run(
            torch, cfg, params, "cpu", label, "fused", rounds,
            follow=trace)}
        free = _small_member_run(torch, cfg, params, "cpu", label, "fused",
                                 rounds)
        if label == "d2":
            # the CPU against itself from an init jittered by 1e-7
            # (relative): how far this run's f32 noise carries
            jittered = _jitter(torch, params, torch.Generator().manual_seed(1))
            floor = _logs_rel_diff(free[1]["log"], _small_member_run(
                torch, cfg, jittered, "cpu", label, "fused",
                rounds)[1]["log"])
            say("small-membership", run=label, against="cpu-whole-run",
                log_max_rel_diff=_logs_rel_diff(free[1]["log"],
                                                card[1]["log"]),
                cpu_jitter_floor=floor)
        else:
            others["cpu"] = free
        if label == "churn":
            others["card-python"] = _small_member_run(
                torch, cfg, params, dev, label, "python", rounds)
        gl, gs, grep, gmat, _ = card
        glog = gs["log"]
        graphs = {f.name: (f.captures, f.replays)
                  for f in gl._runner.graphs.functions}
        for name, (_, os_, orep, omat, _) in others.items():
            olog = os_["log"]
            check([(x.live, x.synced, x.comm_bytes, x.T) for x in olog]
                  == [(x.live, x.synced, x.comm_bytes, x.T) for x in glog],
                  f"4 {label}: card and {name} differ in live counts, "
                  "sync pattern, bills or T")
            check(os_["membership"] == gs["membership"],
                  f"4 {label}: membership logs differ")
            worst = _logs_rel_diff(olog, glog)
            check(worst <= 1e-4, f"4 {label}: card vs {name} logs differ "
                                 f"by {worst} (rel)")
            check(not any(orep["launches"].values())
                  or not name.startswith("cpu"),
                  f"4 {label}: the CPU run launched {orep['launches']}")
            say("small-membership", run=label, against=name,
                log_max_rel_diff=worst)
        caps = grep["captures_after_round"]
        check(len(set(caps)) == 1 and caps[0] >= 1,
              f"4 {label}: captures by round {caps}: a capture after "
              "round 0's")
        check(grep["guard"] == [2] * rounds,
              f"4 {label}: round windows at sync modes {grep['guard']}")
        check(all(grep["dead_rows_unchanged"]),
              f"4 {label}: a dead row moved {grep['dead_rows_unchanged']}")
        check(all(grep.get("rejoin_equals_prev_avg", [])),
              f"4 {label}: a joined row is not the sync reference")
        if label == "gossip-exponential":
            check(all(not np.array_equal(a, b)
                      for a, b in zip(gmat, gmat[1:])),
                  "4 gossip: the matrix did not change every round")
        else:
            check(grep["rejoin_equals_prev_avg"] == [True, True]
                  and len(grep["dead_rows_unchanged"]) == 4,
                  f"4 {label}: rejoins / dead rounds {grep}")
        n_leaves = sum(t.numel() >= 256 for t in leaves(gs["params"]))
        counts = grep["launches"]
        if label == "churn":
            # the live round takes the weighted route: K1 + K2 + einsum
            check(counts["wire_quantize"] == counts["wire_dequantize"]
                  == rounds, f"4 churn: K1/K2 launched {counts}")
        else:
            check(counts["wire_quantize"] == counts["wire_dequantize"]
                  == rounds * n_leaves,
                  f"4 {label}: K1/K2 launched {counts}, not once per "
                  f"quantized leaf ({n_leaves}) per round")
        say("small-membership", run=label, rounds=rounds,
            live=[x.live for x in glog],
            comm_bytes=[x.comm_bytes for x in glog], graphs=graphs,
            captures_after_round=caps, card_launches=counts,
            dead_rows_unchanged=grep["dead_rows_unchanged"],
            rejoin_equals_prev_avg=grep.get("rejoin_equals_prev_avg"),
            matrices=[m.tolist() for m in gmat]
            if label == "gossip-exponential" else None,
            losses_card=[float(sum(x.local_losses) / len(x.local_losses))
                         for x in glog])
    # (iv) (ii)'s round state, saved after round 2 on the card: restored
    # into a fresh learner, and into (ii)'s own after its 4 rounds
    dl, ds, _, _, path = runs.pop("d2")
    uninterrupted = _small_member_run(torch, cfg, params, dev, "d2",
                                      "fused", 4)[1]
    fl, fs, _, _, _ = _small_member_run(torch, cfg, params, dev, "d2",
                                        "fused", 4, restore=path)
    before = dl._runner.graphs.captures
    own = io.restore_round_state(path, ds)
    own["log"] = own["log"][:2]
    batches = epoch_batches_fn(build_data(cfg, 3, 4, 16, 48, seed=0,
                                          k_max=4), dev, 2)
    for _ in range(2):
        own = dl.run_round(own, batches)
    result = {
        "fresh_bitwise": _bitwise_equal(torch, fs, uninterrupted),
        "own_bitwise": _bitwise_equal(torch, own, uninterrupted),
        "losses_bitwise": ([x.local_losses for x in fs["log"][-2:]]
                           == [x.local_losses for x in own["log"][-2:]]
                           == [x.local_losses
                               for x in uninterrupted["log"][-2:]]),
        "membership_equal": (fs["membership"] == own["membership"]
                             == uninterrupted["membership"])}
    say("small-membership", run="checkpoint", **result,
        own_captures=(before, dl._runner.graphs.captures),
        fresh_graphs={f.name: (f.captures, f.replays)
                      for f in fl._runner.graphs.functions})
    check(all(result.values()),
          f"4 checkpoint: the resumed rounds differ from the uninterrupted "
          f"run ({result})")
    check(dl._runner.graphs.captures == before,
          "4 checkpoint: the restore into the running learner captured")
    del runs, dl, ds, fl, fs, own, uninterrupted
    gc.collect()


def _round_events(torch, learner):
    """The device split of each round without a host sync of its own.
    On the fused engine (a round replayed as one graph) the round graph's
    own marks, read with tracing on around each ``run_round``
    (``RoundLog.epochs_ms`` / ``finalize_ms``): the second part is its
    whole finalize (aggregation, Eq. 4, optimizer reset). On the python
    engine three CUDA events recorded between its eager calls: at the
    start of the round's device work, before the aggregation and after
    it. Returns ``read()`` -> (epochs ms, aggregation ms) of the last
    round."""
    if learner.round_engine.name != "python":
        from repro_torch import spans
        run, last = learner.run_round, []

        def traced(*a, **kw):
            spans.enable()
            try:
                state = run(*a, **kw)
            finally:
                spans.disable()
            last[:] = [state["log"][-1]]
            return state
        learner.run_round = traced
        return lambda: (last[0].epochs_ms, last[0].finalize_ms)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    agg, epoch = learner._aggregate_fn, learner._epoch

    def marked(*a, **kw):
        ev[1].record()
        out = agg(*a, **kw)
        ev[2].record()
        return out
    learner._aggregate_fn = marked
    learner._runner = learner.round_engine.bind(learner)
    round_start = [True]

    def timed(*a):
        if round_start[0]:
            ev[0].record()
            round_start[0] = False
        return epoch(*a)
    learner._epoch = timed

    def read():
        ev[2].synchronize()
        round_start[0] = True
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    return read


def phase_main(torch, dev, label, codec, K, rounds, launches_out,
               engine="fused"):
    """One main-path run at full width; returns the launch counts."""
    from repro_torch.data.synthetic import lm_examples
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (build_data, epoch_batches_fn,
                                          eval_loss)
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = full_cfg()
    B, S, steps = 8, 256, 2
    data = build_data(cfg, K, B, S, K * B * steps, seed=0)
    ex, ey = lm_examples(99, 32, S, cfg.vocab_size)
    learner = _learner(torch, cfg, codec, K, dev, engine=engine,
                       rounds=rounds, rule="fle")
    split = _round_events(torch, learner)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    batches = epoch_batches_fn(data, dev, steps)
    torch.cuda.synchronize()
    mem_init = (torch.cuda.max_memory_allocated(),
                torch.cuda.memory_allocated())
    ops.reset_launch_counts()
    per_round = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state = learner.run_round(state, batches)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        epochs_ms, agg_ms = split()
        log = state["log"][-1]
        per_round.append({
            "round": log.round, "T": log.T, "seconds": sec,
            "tokens_per_s": K * steps * B * S * log.T / sec,
            "device_ms": {"epochs": epochs_ms, "aggregation": agg_ms},
            "local_loss": float(sum(log.local_losses)
                                / len(log.local_losses)),
            "rel_change": log.rel_change, "comm_MiB": log.comm_bytes / 2**20,
            "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_GB": torch.cuda.memory_reserved() / 1e9})
    counts = ops.launch_counts()
    ev = eval_loss(learner.shared_model(state), cfg, ex, ey, batch=8)
    peak = torch.cuda.max_memory_allocated()
    graphs = ({f.name: {"captures": f.captures, "replays": f.replays}
               for f in learner._runner.graphs.functions}
              if engine == "fused" else None)
    say("main", run=label, engine=engine, codec=learner.codec.name, K=K,
        reduced=f"n_layers 24 -> {LAYERS} (K f32 model copies + the "
                "(K, N_pad) flat buffer must fit in 80 GB)",
        params_per_participant=tr.count_params(state["params"]) // K,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, batch=B, seq_len=S,
        steps_per_epoch=steps, rounds=per_round, eval_loss=ev,
        peak_mem_GB=peak / 1e9,
        peak_reserved_GB=torch.cuda.max_memory_reserved() / 1e9,
        launches=counts, graphs=graphs,
        quantized_leaves=sum(t.ndim > 0 and t.numel() >= 256
                             for t in leaves(state["params"])),
        mem_GB={"before_init": base / 1e9,
                "peak_through_init": mem_init[0] / 1e9,
                "live_after_init": mem_init[1] / 1e9})
    losses = [r["local_loss"] for r in per_round] + [ev]
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    if engine == "fused":
        rnd = graphs["round"]
        check(rnd["captures"] == len({r["T"] for r in per_round})
              and rnd["replays"] == rounds - 1,
              f"{label}: round graph captured / replayed {rnd}")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    # the timer's closures tie the learner and its runner into a cycle:
    # collect it, so the runner's graph pool goes back to the card now
    del state, learner, split
    gc.collect()
    torch.cuda.empty_cache()
    return per_round, counts


# ---------------------------------------------------------------------------
# phase 9(a): the threshold after the quiet round 0, as a multiple of its
# divergence div0. A synced round's reference is the model it just
# averaged, so a round after a sync drifts about as far as round 0, and a
# round after a quiet one further: 1.051 and 1.357 / 1.338 x div0 at full
# width (NVIDIA H100 80GB HBM3, 700 W, at c = 1.25; 1.5 on the smoke
# model). 1.18 sits >= 11% from each.
GATE_C = 1.18


def _recording_trigger(api, divs):
    """A ``DivergenceTrigger`` whose host gate (the python engine's) logs
    each divergence it decides on; its traced gate is the inherited one."""
    @dataclasses.dataclass(frozen=True)
    class Recording(api.DivergenceTrigger):
        def should_sync(self, div, round_i, delta=None):
            divs.append(div)
            return super().should_sync(div, round_i, delta)
    return Recording


def _gated_events(torch, learner):
    """CUDA events around a gated fused round's parts, recorded between
    the replays (none inside the round's window syncs): before the first
    chunk graph, around the gate graph, around the finalize graph. Returns
    ``read()`` -> device ms of the last round's epochs, gate and finalize
    (None on a quiet round)."""
    runner = learner._runner
    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "gate0", "gate1", "fin0", "fin1")}
    seen = {"first": True, "fin": False}
    epochs, gate, fin = runner._epochs, runner._gate, runner._finalize

    def timed_epochs(*a):
        if seen["first"]:
            ev["start"].record()
            seen["first"] = False
        return epochs(*a)

    def timed_gate(*a):
        ev["gate0"].record()
        out = gate(*a)
        ev["gate1"].record()
        return out

    def timed_fin(*a):
        ev["fin0"].record()
        out = fin(*a)
        ev["fin1"].record()
        seen["fin"] = True
        return out
    runner._epochs, runner._gate, runner._finalize = (timed_epochs,
                                                      timed_gate, timed_fin)

    def read():
        (ev["fin1"] if seen["fin"] else ev["gate1"]).synchronize()
        out = {"epochs": ev["start"].elapsed_time(ev["gate0"]),
               "gate": ev["gate0"].elapsed_time(ev["gate1"]),
               "finalize": (ev["fin0"].elapsed_time(ev["fin1"])
                            if seen["fin"] else None)}
        seen["first"], seen["fin"] = True, False
        return out
    return read


def phase_gated(torch, dev, launches_out):
    """9(a): the divergence trigger at full width (fused int8, K=5, T
    fixed, 4 rounds). Round 0 at δ = inf is quiet and measures div0; then
    ``set_sync_policy(DivergenceTrigger(delta=GATE_C * div0))`` (no rebind,
    no capture). The fused engine's rounds, then the same rounds under the
    python engine on the card: the same pattern, losses within 1e-4."""
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_data, epoch_batches_fn
    from repro_torch.models import transformer as tr
    cfg = full_cfg()
    K, B, S, steps, rounds = 5, 8, 256, 2, 4
    data = build_data(cfg, K, B, S, K * B * steps, seed=0)
    out, delta = {}, None
    for engine in ("fused", "python"):
        host_divs = []
        Recording = _recording_trigger(api, host_divs)
        learner = _learner(torch, cfg, api.get_codec("fused"), K, dev,
                           engine=engine, rounds=rounds,
                           sync_policy=Recording(delta=float("inf")))
        if engine == "fused":
            gate, dev_divs = _record_gate(learner)
            split = _gated_events(torch, learner)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = learner.init(tr.init_params(0, cfg, torch.float32,
                                            device=dev))
        batches = epoch_batches_fn(data, dev, steps)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        per_round = []
        for i in range(rounds):
            if i == 1:
                if delta is None:
                    delta = GATE_C * state["log"][0].rel_change
                runner = learner._runner
                learner.set_sync_policy(Recording(delta=delta))
                check(learner._runner is runner,
                      f"9a {engine}: the delta swap rebound the engine")
            t0 = time.perf_counter()
            state = learner.run_round(state, batches)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            log = state["log"][-1]
            per_round.append({
                "round": log.round, "synced": log.synced,
                "delta": float("inf") if i == 0 else delta,
                "seconds": sec,
                "device_ms": split() if engine == "fused" else None,
                "local_loss": float(sum(log.local_losses)
                                    / len(log.local_losses)),
                "rel_change": log.rel_change,
                "comm_MiB": log.comm_bytes / 2**20,
                "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
        counts = ops.launch_counts()
        divs = ([float(d) for d in dev_divs] if engine == "fused"
                else host_divs)
        for r, d in zip(per_round, divs):
            r["div"] = d
            r["margin"] = (abs(d - r["delta"]) / r["delta"]
                           if math.isfinite(r["delta"]) else None)
        graphs = ({f.name: {"captures": f.captures, "replays": f.replays}
                   for f in learner._runner.graphs.functions}
                  if engine == "fused" else None)
        synced = [r["synced"] for r in per_round]
        n_sync = sum(synced)
        say("gated", run=f"9a-{engine}", engine=engine, K=K,
            codec=learner.codec.name, c=GATE_C, delta=delta,
            reduced=f"n_layers 24 -> {LAYERS} (as phase 5)",
            rounds=per_round, launches=counts, graphs=graphs,
            peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
            peak_reserved_GB=torch.cuda.max_memory_reserved() / 1e9)
        check(not synced[0] and True in synced[1:] and False in synced[1:],
              f"9a {engine}: sync pattern {synced}")
        check(all(r["margin"] > 0.05 for r in per_round[1:]),
              f"9a {engine}: a decision within 5% of delta "
              f"{[r['margin'] for r in per_round]}")
        check(all(r["comm_MiB"] == 0 for r in per_round if not r["synced"]),
              f"9a {engine}: a quiet round billed bytes")
        check(all(math.isfinite(r["local_loss"]) for r in per_round),
              f"9a {engine}: non-finite loss")
        check(counts["wire_quant_avg_dequant"] == n_sync,
              f"9a {engine}: K3 launched {counts['wire_quant_avg_dequant']} "
              f"times for {n_sync} synced rounds")
        if engine == "fused":
            check(graphs["gate"] == {"captures": 1, "replays": rounds}
                  and graphs["finalize"] == {"captures": 1,
                                             "replays": n_sync}
                  and graphs["round"]["captures"] == 0,
                  f"9a: graphs {graphs}")
            for name, n in counts.items():
                launches_out[name] = launches_out.get(name, 0) + n
            del gate, split
        out[engine] = per_round
        # the runner holds the graphs and their pool
        del state, learner, runner
        gc.collect()
        torch.cuda.empty_cache()
    fused, python = out["fused"], out["python"]
    check([r["synced"] for r in fused] == [r["synced"] for r in python],
          "9a: the engines' sync patterns differ")
    worst = max(abs(a["local_loss"] - b["local_loss"])
                / abs(a["local_loss"]) for a, b in zip(fused, python))
    check(worst <= 1e-4, f"9a: fused vs python losses differ by {worst}")
    say("gated", run="9a-compare", loss_max_rel_diff=worst)


# 9(b)'s row check reads the leaves of fewer values a participant than
# this (the norms and the attention projections, 201M of 1.39e9 values)
ROW_CHECK_MAX = 10**8


def _recording_aggregate(torch, learner, stacked):
    """Wrap the learner's aggregate so that it copies its input's leaves
    of fewer than ``ROW_CHECK_MAX`` values a participant (the stacked
    params after the epochs) into buffers allocated here, outside any
    capture, and rebind the engine so its graphs capture the wrapper.
    Returns the buffers by leaf path."""
    from repro_torch.tree import leaves_with_path
    bufs = {path: torch.empty_like(t) for path, t in leaves_with_path(stacked)
            if t[0].numel() < ROW_CHECK_MAX}
    agg = learner._aggregate_fn

    def recording(stacked, *rest, **kw):
        with torch.no_grad():
            for path, t in leaves_with_path(stacked):
                if path in bufs:
                    bufs[path].copy_(t)
        return agg(stacked, *rest, **kw)
    learner._aggregate_fn = recording
    learner._runner = None
    gc.collect()
    torch.cuda.empty_cache()
    learner._runner = learner.round_engine.bind(learner)
    return bufs


def _row_error(torch, params, inputs, weights, block):
    """The largest distance of any participant's row of ``params`` (the
    round's result) from the weighted mean of the sampled rows' wire
    roundtrip, computed from the aggregate's recorded ``inputs`` by the
    plain quantize and dequantize a participant and a leaf at a time (a
    leaf starts on a block of the flat buffer, so its blocks are the
    flat roundtrip's)."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.tree import leaves_with_path
    out = dict(leaves_with_path(params))
    err = 0.0
    for path, x in inputs.items():
        want = 0
        for j in map(int, np.nonzero(weights)[0]):
            q, s, shp = ref.quantize_blockwise_ref(x[j], block=block, bits=8)
            want = want + float(weights[j]) * ref.dequantize_blockwise_ref(
                q, s, shp, bits=8)
            del q, s
        err = max(err, float((out[path] - want).abs().max()))
        del want
    return err


def phase_partial_ragged(torch, dev, launches_out):
    """9(b): partial participation (m=2) over the fused int8 codec's flat
    roundtrip (K1 and K2 over the (K, N_pad) buffer) on ragged shards of
    3, 2 and 1 batches of 8 x 256 (a (3, 3) mask, the shard sizes as the
    FedAvg weights), K=3, the fused engine at full width: 2 timed rounds
    of the path as it ships, then 2 untimed check rounds whose aggregate
    also records its input, so every participant's new row is held
    against the weighted mean of the sampled rows' plain roundtrip."""
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_data, epoch_batches_fn
    from repro_torch.models import transformer as tr
    import numpy as np
    cfg = full_cfg()
    K, B, S, rounds = 3, 8, 256, 2
    data = build_data(cfg, K, B, S, 6 * B, seed=0, partition="sizes",
                      sizes=[3 * B, 2 * B, B])
    check(data.batch_mask.sum(1).tolist() == [3, 2, 1],
          f"9b: shards of {data.batch_counts} batches")
    learner = _learner(torch, cfg, api.get_codec("fused"), K, dev,
                       rounds=2 * rounds, rule="fle",
                       aggregator=api.PartialParticipation(m=2),
                       shard_sizes=data.sizes, batch_mask=data.batch_mask)
    check(learner.aggregator.weights == data.sizes,
          "9b: the shard sizes are not the partial weights")
    agg = learner._aggregate_fn
    split = _round_events(torch, learner)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    batches = epoch_batches_fn(data, dev, 3)
    torch.cuda.synchronize()

    def run(n, timed):
        nonlocal state
        ops.reset_launch_counts()
        per_round = []
        for _ in range(n):
            t0 = time.perf_counter()
            state = learner.run_round(state, batches)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            log = state["log"][-1]
            W = learner.aggregator.mixing_matrix(log.round, K)
            r = {"round": log.round, "seconds": sec,
                 "sampled": np.nonzero(W[0])[0].tolist(),
                 "weights": W[0].tolist(),
                 "local_loss": float(sum(log.local_losses)
                                     / len(log.local_losses)),
                 "comm_bytes": log.comm_bytes,
                 "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
            if timed:
                epochs_ms, agg_ms = split()
                r["device_ms"] = {"epochs": epochs_ms,
                                  "aggregation": agg_ms}
            else:
                r["row_err"] = _row_error(torch, state["params"], inputs,
                                          W[0], learner.codec.block)
            per_round.append(r)
        return per_round, ops.launch_counts()

    per_round, counts = run(rounds, timed=True)
    peak = (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)
    graphs = {f.name: {"captures": f.captures, "replays": f.replays}
              for f in learner._runner.graphs.functions}
    del split
    learner._aggregate_fn = agg
    inputs = _recording_aggregate(torch, learner, state["params"])
    checked, c_counts = run(rounds, timed=False)
    up = learner.codec.wire_bytes(state["params"])
    bill = math.ceil(2 * up / K) + learner.param_bytes(state)
    say("partial-ragged", run="9b", K=K, m=2, codec=learner.codec.name,
        shard_sizes=list(data.sizes),
        mask=data.batch_mask.astype(int).tolist(),
        reduced=f"n_layers 24 -> {LAYERS} (as phase 5)",
        rounds=per_round, launches=counts, graphs=graphs,
        check_rounds=checked, check_launches=c_counts,
        check_leaves=sorted(inputs), bill_formula=bill, wire_bytes=up,
        peak_mem_GB=peak[0], peak_reserved_GB=peak[1])
    for label, c in (("timed", counts), ("check", c_counts)):
        check(c["wire_quantize"] == c["wire_dequantize"] == rounds,
              f"9b {label}: K1/K2 launched {c['wire_quantize']} / "
              f"{c['wire_dequantize']} times in {rounds} rounds")
    check(graphs["round"] == {"captures": 1, "replays": rounds - 1},
          f"9b: round graph {graphs['round']}")
    check(all(r["row_err"] <= 1e-6 for r in checked),
          f"9b: a row is {[r['row_err'] for r in checked]} from the "
          "sampled rows' weighted mean")
    check(all(r["comm_bytes"] == bill for r in per_round + checked),
          f"9b: billed {[r['comm_bytes'] for r in per_round + checked]}, "
          f"the formula gives {bill}")
    check(all(math.isfinite(r["local_loss"]) for r in per_round + checked),
          "9b: non-finite loss")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    del state, learner, inputs
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10's depth: 12 of internlm2-1.8b's 24 layers (P = 1,134,086,144,
# 4.54 GB a model in f32). D² at K = 5 holds the stacked params and the
# correction (K f32 models each), prev_avg, the epochs' and the leaf-wise
# mix's temporaries (about three copies of the largest stacked leaf): at
# 8 layers its peak was 51.57 GB (NVIDIA H100 80GB HBM3, 700 W); scaled
# to 12 ≈ 63.4 GB, to 14 ≈ 71 GB (under 8 GB free), to 16 ≈ 78.5 GB.
# Depth 2, for the script's clock: phase 10 took 98.0 s at depth 12 on a
# host where the whole script took 1,435 s (with phase 16), and 38.4 s at
# depth 4 where it took 808.4 s (NVIDIA H100 80GB HBM3, 700 W).
LAYERS10 = 2
# slot 3 of the paper's five data centers crashes at round 1 and rejoins
# at round 3
CHURN10 = (("crash", 1, 3), ("rejoin", 3, 3))
# 10(c)'s mix check: two sampled leaves (a norm and an attention
# projection) recorded before every check round's mix
MIX_CHECK_LEAVES = ("final_norm/g", "segments/0/p0/mixer/wk")


def cfg10():
    from repro_torch.configs import get_config
    return get_config("internlm2-1.8b").with_(
        n_layers=LAYERS10, segments=((("gqa:dense",), LAYERS10),))


def _d2_mix_error(torch, state, bufs, W, live):
    """The largest distance of any live row of the round's params and
    correction from D²'s mix of the aggregate's recorded inputs
    (``_record_aggregate``), recomputed by the plain quantize and
    dequantize of the stacked leaf (the leafwise codec's blocks run
    across its K rows) and the matrix."""
    from repro_torch.kernels import ref
    from repro_torch.tree import leaves_with_path
    params, corr = (dict(leaves_with_path(state["params"])),
                    dict(leaves_with_path(state["residual"])))
    Wt = torch.tensor(W, device=params[MIX_CHECK_LEAVES[0]].device)
    err = 0.0
    for p in MIX_CHECK_LEAVES:
        y, c = bufs["0/" + p], bufs["1/" + p]
        v = y + c
        q, sc, shp = ref.quantize_blockwise_ref(v, block=256, bits=8)
        rt = ref.dequantize_blockwise_ref(q, sc, shp, bits=8)
        del q, sc
        for k in map(int, live.nonzero()[0]):
            want = Wt[k, k] * v[k]
            for j in range(len(W)):
                if j != k and W[k][j] != 0:
                    want = want + Wt[k, j] * rt[j]
            err = max(err, float((params[p][k] - want).abs().max()),
                      float((corr[p][k] - (want - y[k])).abs().max()))
        del v, rt
    return err


def _run10(torch, dev, label, make, K, rounds, engine, launches_out,
           check_rounds=0):
    """One phase 10 run at full width and depth ``LAYERS10``: ``make(api,
    membership)`` gives the learner's strategies. Per round: host
    seconds, the device split (epochs / finalize, CUDA events), the live
    count, the bill, the mixing matrix and the peak memory; the dead rows'
    sums of the round state. ``check_rounds`` (D²) more rounds follow
    untimed, each live row's mix checked on the sampled leaves."""
    import numpy as np
    from repro_torch.core import api, membership
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_data, epoch_batches_fn
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = cfg10()
    B, S, steps = 8, 256, 2
    data = build_data(cfg, K, B, S, K * B * steps, seed=0)
    kw = make(api, membership)
    learner = _learner(torch, cfg, kw.pop("codec"), K, dev, engine=engine,
                       rounds=rounds + check_rounds, rule="fle", **kw)
    split = _round_events(torch, learner)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    batches = epoch_batches_fn(data, dev, steps)
    torch.cuda.synchronize()
    mem_init = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    per_round, caps, frozen = [], [], []
    n_leaves = sum(t.numel() >= 256 for t in leaves(state["params"]))

    def dead_sums(st, dead):
        """Each dead row's sum per leaf of the params and round state."""
        return [float(t[k].double().sum()) for k in dead
                for key in ("params", "residual") for t in leaves(st[key])]

    for _ in range(rounds):
        dead = [k for k, a in enumerate(
            learner.churn.live_mask(state["round"], K)) if not a]
        sums = dead_sums(state, dead)
        t0 = time.perf_counter()
        state = learner.run_round(state, batches)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        epochs_ms, fin_ms = split()
        log = state["log"][-1]
        if sums:
            frozen.append(sums == dead_sums(state, dead))
        caps.append(learner._runner.graphs.captures
                    if engine == "fused" else None)
        per_round.append({
            "round": log.round, "live": f"{log.live}/{K}", "seconds": sec,
            "device_ms": {"epochs": epochs_ms, "finalize": fin_ms},
            "local_loss": float(sum(log.local_losses)
                                / len(log.local_losses)),
            "rel_change": log.rel_change, "comm_bytes": log.comm_bytes,
            "matrix": (learner._weights_np.tolist()
                       if learner._weights_np is not None else None),
            "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)
    graphs = ({f.name: {"captures": f.captures, "replays": f.replays}
               for f in learner._runner.graphs.functions}
              if engine == "fused" else None)
    wire = learner.codec.wire_bytes(state["params"])
    checked = []
    if check_rounds:
        del split
        bufs = _record_aggregate(
            torch, learner, state,
            [f"{i}/{p}" for i in (0, 1) for p in MIX_CHECK_LEAVES])
        for _ in range(check_rounds):
            live = learner.churn.live_mask(state["round"], K)
            state = learner.run_round(state, batches)
            W = learner.aggregator.mixing_matrix(state["round"] - 1, K,
                                                 live=live)
            checked.append(_d2_mix_error(torch, state, bufs, W, live))
        del bufs
    say("churn-gossip", run=label, engine=engine, K=K,
        codec=learner.codec.name, aggregator=learner.aggregator.name,
        reduced=f"n_layers 24 -> {LAYERS10} (the script's clock: 4 "
                "before, 6 before phase 17 was added; 12 is "
                "the most that leaves >= 8 GB of 80 free beside the D² "
                "run's K params, K correction copies and the mix's "
                "temporaries)",
        params_per_participant=tr.count_params(state["params"]) // K,
        batch=B, seq_len=S, steps_per_epoch=steps, rounds=per_round,
        launches=counts, quantized_leaves=n_leaves, graphs=graphs,
        captures_after_round=caps, dead_state_frozen=frozen,
        wire_bytes=wire, mix_check_max_abs_err=checked,
        mix_check_leaves=list(MIX_CHECK_LEAVES) if checked else None,
        live_after_init_GB=mem_init / 1e9, peak_mem_GB=peak[0],
        peak_reserved_GB=peak[1])
    check(all(math.isfinite(r["local_loss"]) for r in per_round),
          f"10 {label}: non-finite loss")
    check(peak[1] < 80, f"10 {label}: {peak[1]} GB reserved")
    check(counts["wire_quantize"] == counts["wire_dequantize"]
          == rounds * n_leaves,
          f"10 {label}: K1/K2 launched {counts['wire_quantize']} / "
          f"{counts['wire_dequantize']}, not {n_leaves} a round")
    if engine == "fused":
        check(len(set(caps)) == 1 and graphs["round"] == {
            "captures": 1, "replays": rounds - 1},
            f"10 {label}: captures by round {caps}, graphs {graphs}")
    check(all(frozen), f"10 {label}: a dead slot's round state moved")
    check(all(e <= 1e-6 for e in checked),
          f"10 {label}: a live row is {checked} from the D² mix")
    if engine == "fused":
        for name, n in counts.items():
            launches_out[name] = launches_out.get(name, 0) + n
    del state, learner
    gc.collect()
    torch.cuda.empty_cache()
    return per_round, wire


def phase_churn_gossip(torch, dev, launches_out):
    """Phase 10 at internlm2-1.8b's full width, depth ``LAYERS10``, K = 5
    (the paper's five data centers), leafwise int8, T fixed at 1: (a)
    elastic membership (``CHURN10``) over the live-renormalised
    FullAverage, 4 rounds fused then 4 python; (b) GraphGossip over the
    time-varying exponential graph, 3 rounds; (c) D² over the ring under
    (a)'s churn, 4 timed rounds, then 2 check rounds."""
    import numpy as np
    K = 5

    def churn(m):
        return m.ScriptedChurn(events=CHURN10)
    out = {}
    for engine in ("fused", "python"):
        out[engine], _ = _run10(
            torch, dev, f"10a-{engine}", lambda a, m: {
                "codec": a.get_codec("leafwise"), "churn": churn(m)},
            K, 4, engine, launches_out)
    for r in out["fused"] + out["python"]:
        check(r["live"] == {1: "4/5", 2: "4/5"}.get(r["round"], "5/5"),
              f"10a: round {r['round']} ran {r['live']} live")
    worst = max(abs(a["local_loss"] - b["local_loss"]) / abs(a["local_loss"])
                for a, b in zip(out["fused"], out["python"]))
    check(worst <= 1e-4, f"10a: fused vs python losses differ by {worst}")
    check([r["comm_bytes"] for r in out["fused"]]
          == [r["comm_bytes"] for r in out["python"]], "10a: bills differ")
    say("churn-gossip", run="10a-compare", loss_max_rel_diff=worst)
    rounds_b, wire = _run10(
        torch, dev, "10b", lambda a, m: {
            "codec": a.get_codec("leafwise"),
            "aggregator": a.GraphGossip("exponential")},
        K, 3, "fused", launches_out)
    mats = [np.asarray(r["matrix"]) for r in rounds_b]
    check(all(not np.array_equal(a, b) for a, b in zip(mats, mats[1:])),
          "10b: the exponential graph's matrix did not change per round")
    for r, W in zip(rounds_b, mats):
        edges = int(np.count_nonzero(W) - np.count_nonzero(np.diag(W)))
        check(r["comm_bytes"] == math.ceil(2 * edges * wire / K),
              f"10b: round {r['round']} billed {r['comm_bytes']}")
    _run10(torch, dev, "10c", lambda a, m: {
        "codec": a.get_codec("leafwise"),
        "aggregator": a.D2Gossip("ring"), "churn": churn(m)},
        K, 4, "fused", launches_out, check_rounds=2)


# ---------------------------------------------------------------------------
# phase 11: continuous operation. (a)'s stream drifts by a covariate shift of
# the tokens (a growing share of vocab pairs swapped), so every round's
# contents differ; ILE's ε is one no round's rel reaches, so T stays 1.
COV11 = 0.1
EPS11 = 1e-6
# 11(d)'s examples at the sizes of their CPU tests (at their defaults they
# took 79-91 s of the script; phase 14 bought that time back)
EXAMPLES11 = {"quickstart": ("--n-examples", "200"),
              "compressed_wan": ("--n-examples", "100"),
              "elastic_membership": ("--n-examples", "160"),
              "graph_gossip": ("--n-examples", "160"),
              "serve_decode": ("--n-examples", "90"),
              "continuous_serving": ()}


def _params_equal(torch, a, b):
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _eager_tokens(torch, cfg, params, prompts, new, max_seq):
    """Greedy tokens of an eager ``decode_step`` loop (no graph)."""
    from repro_torch.models import transformer as tr
    B, P = prompts.shape
    cache = tr.init_cache(cfg, B, max_seq, torch.float32, prompts.device)
    pos = torch.arange(max_seq, dtype=torch.int32, device=prompts.device)
    for t in range(P):
        logits, cache = tr.decode_step(params, cfg, cache,
                                       prompts[:, t:t + 1], pos[t])
    tok, out = torch.argmax(logits, -1), []
    for i in range(new):
        out.append(tok)
        logits, cache = tr.decode_step(params, cfg, cache, tok, pos[P + i])
        tok = torch.argmax(logits, -1)
    return torch.cat(out, dim=1)


def phase_continuous(torch, dev, launches_out):
    """11(a): continuous operation at internlm2-1.8b's full width, depth
    ``LAYERS10``: K = 3, the fused int8 codec (K3 every round), ILE with T
    fixed at 1, batch 8 x 256, 2 steps an epoch, over a token stream under
    ``CovariateDrift``; each round publishes into a shared-mode
    ``ModelBank`` (``run_round``'s ``on_round_end``), a ``ServeLoop``
    (batch 8, 128-token prompt, 64 new tokens, max_seq 256) polls and
    generates. Round 0 captures the round graph, rounds 1-3 replay it. Per
    round: round s (host clock + sync), swap ms (synced), decode tokens/s,
    prompt s, version, staleness, captures, peak memory, K3 launches. The
    loop's params equal ``shared_model`` bit for bit after each poll, and
    the version it served equals its snapshot bit for bit after the next
    round; after the last swap its tokens equal an eager decode loop over
    the bank's params; every round's window runs under the sync guard."""
    from repro_torch.analysis import guards
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.data.stream import CovariateDrift, ShardStream
    from repro_torch.data.synthetic import lm_examples
    from repro_torch.kernels import ops
    from repro_torch.launch.train import epoch_batches_fn, make_loss_fn
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ModelBank, ServeLoop
    cfg = cfg10()
    K, B, S, steps, rounds = 3, 8, 256, 2, 4
    SB, P, new, max_seq = 8, 128, 64, 256
    x, y = lm_examples(0, K * B * steps, S, cfg.vocab_size)
    stream = ShardStream([x, y], K, B, 0, drift=CovariateDrift(rate=COV11))
    learner = CoLearner(
        CoLearnConfig(n_participants=K, T0=1, eta0=0.05, epsilon=EPS11,
                      max_rounds=rounds),
        make_loss_fn(cfg), codec=api.get_codec("fused"),
        round_engine="fused", device=dev)
    check(learner.sync_policy.name == "ile", "11a: not under ILE")
    runner = learner._runner
    graph, guard = runner._round, []

    def round_graph(*a):
        guard.append(torch.cuda.get_sync_debug_mode())
        return graph(*a)
    runner._round = round_graph
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    bank = ModelBank()
    bank.publish(learner.shared_model(state), round_i=0)  # v1: the init
    loop = ServeLoop(cfg, learner.shared_model(state), batch=SB,
                     max_seq=max_seq, device=dev)
    check(loop.poll(bank) and loop.version == 1, "11a: v1 not served")
    g = torch.Generator(device=dev).manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (SB, P), generator=g,
                            device=dev)
    loop.generate(prompts[:, :8], 4)                        # warm-up
    batches = epoch_batches_fn(stream, dev, steps)
    torch.cuda.synchronize()
    mem_init = torch.cuda.memory_allocated()
    served = bank.current()
    tokens0 = [stream.epoch_batches(r, 0)[0] for r in range(rounds)]
    check(all(not (a == b).all() for a, b in zip(tokens0, tokens0[1:])),
          "11a: the stream's contents did not change every round")
    per_round = []
    ops.reset_launch_counts()
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = learner.run_round(state, batches,
                                  on_round_end=bank.publish_from)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        log = state["log"][-1]
        # the version the loop serves is its snapshot, untouched by the round
        kept = _params_equal(torch, loop.params, served.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swapped = loop.poll(bank)
        torch.cuda.synchronize()
        swap_ms = 1e3 * (time.perf_counter() - t0)
        served = bank.current()
        shared = learner.shared_model(state)
        equal = (_params_equal(torch, loop.params, shared)
                 and _params_equal(torch, loop.params, served.params))
        del shared
        with guards.no_transfer(dev):
            gen, st = loop.generate(prompts, new)
        per_round.append({
            "round": log.round, "T": log.T, "synced": log.synced,
            "round_s": round_s, "swap_ms": swap_ms, "swapped": swapped,
            "decode_tokens_per_s": st["tokens_per_s"],
            "decode_ms_per_step": 1e3 * st["decode_s"] / new,
            "prompt_s": st["prefill_s"], "version": loop.version,
            "staleness": bank.staleness(state["round"]),
            "round_graph_captures": graph.captures,
            "loop_captures": loop.compile_count(),
            "local_loss": float(sum(log.local_losses)
                                / len(log.local_losses)),
            "rel_change": log.rel_change, "comm_bytes": log.comm_bytes,
            "loop_equals_shared_model": equal,
            "previous_snapshot_unchanged": kept,
            "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_GB": torch.cuda.memory_reserved() / 1e9,
            "k3_launches": ops.launch_counts()["wire_quant_avg_dequant"]})
    counts = ops.launch_counts()
    eager = _eager_tokens(torch, cfg, bank.current().params, prompts, new,
                          max_seq)
    tokens_equal = bool(torch.equal(gen, eager))
    peak = (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)
    say("continuous", run="11a", model=cfg.name, K=K,
        codec=learner.codec.name, sync=learner.sync_policy.name,
        drift=f"covariate rate {COV11}",
        reduced=f"n_layers 24 -> {LAYERS10} (phase 10's depth: K = 3 "
                "training copies, the (K, N_pad) wire buffer, the loop's "
                "params and the bank's snapshot on one card)",
        params_per_participant=tr.count_params(served.params),
        batch=B, seq_len=S, steps_per_epoch=steps,
        serve={"batch": SB, "prompt_len": P, "new_tokens": new,
               "max_seq": max_seq},
        rounds=per_round, launches=counts,
        graphs={f.name: {"captures": f.captures, "replays": f.replays}
                for f in runner.graphs.functions},
        window_sync_debug_modes=guard, tokens_equal_eager=tokens_equal,
        live_after_init_GB=mem_init / 1e9, peak_mem_GB=peak[0],
        peak_reserved_GB=peak[1])
    check(all(r["T"] == 1 and r["synced"] for r in per_round),
          f"11a: T or sync moved: {[(r['T'], r['synced']) for r in per_round]}")
    check([r["version"] for r in per_round] == [2, 3, 4, 5]
          and all(r["swapped"] and r["staleness"] == 0 for r in per_round),
          "11a: versions / swaps / staleness off")
    check(all(r["loop_equals_shared_model"] for r in per_round),
          "11a: a swap did not copy the shared model bit for bit")
    check(all(r["previous_snapshot_unchanged"] for r in per_round),
          "11a: a published snapshot moved in the next round")
    check(all(r["round_graph_captures"] == 1 and r["loop_captures"] == 1
              for r in per_round)
          and graph.replays == rounds - 1,
          f"11a: captures by round {[(r['round_graph_captures'], r['loop_captures']) for r in per_round]}")
    check(guard == [2] * rounds, f"11a: round windows at sync modes {guard}")
    check(counts["wire_quant_avg_dequant"] == rounds,
          f"11a: K3 launched {counts['wire_quant_avg_dequant']} times")
    check(tokens_equal, "11a: the loop's tokens after the swap differ from "
                        "an eager decode loop over the bank's params")
    check(all(math.isfinite(r["local_loss"]) for r in per_round),
          "11a: non-finite loss")
    check(peak[1] < 80, f"11a: {peak[1]} GB reserved")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    del state, learner, runner, graph, loop, bank, served, gen, eager
    gc.collect()
    torch.cuda.empty_cache()


def phase_continuous_cli(torch):
    """11(b): the continuous CLI on the card at its smoke defaults under
    the divergence trigger and an abrupt drift at round 2, 4 rounds, each
    version persisted; exit 0 with one decode capture."""
    import io
    from repro_torch.launch import continuous
    bank_dir = ROOT / "build" / "continuous_bank"
    shutil.rmtree(bank_dir, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = continuous.main(["--device", "cuda", "--sync-policy",
                              "divtrigger", "--drift", "abrupt",
                              "--drift-round", "2", "--rounds", "4",
                              "--bank-dir", str(bank_dir)])
    seconds = time.perf_counter() - t0
    out = buf.getvalue().splitlines()
    rounds = [x for x in out if x.startswith("round ")]
    persisted = sorted(p.name for p in bank_dir.glob("v*.npz"))
    shutil.rmtree(bank_dir, ignore_errors=True)
    say("continuous", run="11b", rc=rc, seconds=seconds, lines=out,
        persisted=persisted)
    check(rc == 0 and len(rounds) == 4, f"11b: rc {rc}, lines {out}")
    check(all("compiles=1" in x for x in rounds), "11b: a recapture")
    check(len(persisted) >= 1, "11b: no version persisted")


def phase_small_continuous(torch, dev):
    """11(c), a phase 4 run: continuous operation on the smoke config, K=3,
    fused int8, the divergence trigger at ``SMALL_GATE_DELTA`` over a
    stream with an abrupt drift at round 2, ``publish_from`` as the hook,
    4 rounds through the fused engine, the card against the CPU: rounds
    within 1e-4, equal sync patterns, bills, versions and staleness, every
    divergence > 5% from δ."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.colearn import CoLearner
    from repro_torch.data.stream import AbruptDrift, ShardStream
    from repro_torch.data.synthetic import lm_examples
    from repro_torch.kernels import ops
    from repro_torch.launch.train import epoch_batches_fn, make_loss_fn
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ModelBank
    cfg = get_smoke_config("internlm2-1.8b")
    K, rounds = 3, 4
    x, y = lm_examples(0, 48, 16, cfg.vocab_size)
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    runs = {}
    for d in ("cpu", dev):
        stream = ShardStream([x, y], K, 4, 0, drift=AbruptDrift(at_round=2))
        learner = CoLearner(
            CoLearnConfig(n_participants=K, T0=1, eta0=0.05,
                          epochs_rule="fle", max_rounds=rounds),
            make_loss_fn(cfg), codec=api.get_codec("fused"),
            round_engine="fused",
            sync_policy=api.DivergenceTrigger(delta=SMALL_GATE_DELTA),
            device=d)
        gate, divs = _record_gate(learner)
        state = learner.init(params)
        bank = ModelBank()
        bank.publish(learner.shared_model(state), round_i=0)
        ops.reset_launch_counts()
        vers = []
        for _ in range(rounds):
            state = learner.run_round(state, epoch_batches_fn(stream, d, 2),
                                      on_round_end=bank.publish_from)
            vers.append((bank.version, bank.staleness(state["round"])))
        runs[str(d)] = (state["log"], vers, [float(v) for v in divs],
                        ops.launch_counts(), learner._runner.graphs.captures)
        del learner, state, gate, bank
        gc.collect()
    (clog, cver, cdivs, ccounts, _), (glog, gver, gdivs, gcounts,
                                      gcaps) = runs["cpu"], runs[str(dev)]
    worst = 0.0
    for a, b in zip(clog, glog):
        for u, v in [*zip(a.local_losses, b.local_losses),
                     (a.rel_change, b.rel_change)]:
            if math.isinf(u):
                check(math.isinf(v), "11c: rel_change inf on one side only")
                continue
            worst = max(worst, abs(u - v) / max(abs(u), 1e-12))
    margin = min(abs(v - SMALL_GATE_DELTA) / SMALL_GATE_DELTA
                 for v in cdivs + gdivs)
    synced = [x.synced for x in glog]
    say("small-continuous", run="11c", rounds=rounds, K=K, synced=synced,
        versions_staleness=gver, comm_bytes=[x.comm_bytes for x in glog],
        log_max_rel_diff=worst, divergences_card=gdivs,
        divergences_cpu=cdivs, margin=margin, card_launches=gcounts,
        captures=gcaps)
    check(margin > 0.05, f"11c: a divergence within {margin:.1%} of delta")
    check(synced == [x.synced for x in clog] and gver == cver
          and [x.comm_bytes for x in glog] == [x.comm_bytes for x in clog],
          f"11c: card {synced} {gver} vs CPU {[x.synced for x in clog]} "
          f"{cver}")
    check(0 < sum(synced) < rounds, f"11c: pattern {synced}")
    check(worst <= 1e-4, f"11c: card vs CPU logs differ by {worst} (rel)")
    check(gcounts["wire_quant_avg_dequant"] == sum(synced)
          and not any(ccounts.values()),
          f"11c: K3 launched {gcounts} for {sum(synced)} syncs")
    check(gcaps == 3, f"11c: {gcaps} captures (epochs, gate, finalize)")


def phase_examples(torch, examples=EXAMPLES11, tag="11d"):
    """11(d) (and 12(e)): each torch example once on the card at the sizes
    ``examples`` gives it, in this process (``main(["--device", "cuda",
    *args])``): exit 0; the wire kernels launched by the compressed-WAN
    walkthrough are recorded."""
    import importlib.util
    import io
    from repro_torch.kernels import ops
    for name, args in examples.items():
        path = ROOT / "examples" / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["--device", "cuda", *args])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        out = buf.getvalue().splitlines()
        say("examples", part=tag, example=f"torch_{name}", args=args,
            reduced=("the example's defaults -> " + " ".join(args)
                     + " (the script's clock)" if args else None),
            rc=rc, seconds=seconds, launches=counts, tail=out[-8:])
        check(rc == 0, f"{tag}: torch_{name} returned {rc}")
        if name == "compressed_wan":
            check(all(counts.get(k, 0) > 0 for k in (
                "wire_quantize", "wire_dequantize", "wire_quant_avg_dequant",
                "wire_quant_avg_dequant_ef")),
                f"{tag}: compressed_wan launched {counts}")
        del mod
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the paper's own tasks (``repro_torch.paper_tasks``). (a)'s
# batch is the harness's; (d) is resnet_tiny at K = 5, the fused engine,
# 2 steps an epoch, 3 rounds, under each wire codec with a kernel.
# (b) and (c) are paced by the host's dispatch, so their time follows the
# host's speed: (c)'s Tables 4-6 took 155.6 s at 4 rounds on one host and
# 276.9 s on a slower one, where the whole script reached 1,106 s of its
# 1,200 (NVIDIA H100 80GB HBM3, 700 W). Phase 14 (training the recurrent
# families, ~300 s, host-bound) took their time back: Table 2 runs 3
# rounds of its 6 (``ROUNDS12B``; it took 57 s at 6), Tables 4-6 1 round
# of their 5 (T 1; 57 s at 2 rounds, 106.3 s at 3) and the sweep 2 of its
# 5 (28 s at 5); n stays 4,000 in all. Phase 16 took more back: Table 2
# runs 2 rounds (62.3 s at 3) and the sweep 1 (on a host where the whole
# script took 1,435 s).
BATCH12 = 32
ROUNDS12B = 2
ROUNDS12C = 1
SWEEP12C = 1
TOL12 = {"rtol": 1e-5, "atol": 1e-5}
CODECS12 = {"fused": ("wire_quant_avg_dequant",),
            "leafwise": ("wire_quantize", "wire_dequantize")}
# 12(e) at half the examples and fewer rounds (defaults 2,000 / 3 and
# 3,000 / 5: 54-85 s of the script)
EXAMPLES12 = {"heterogeneous_shards": ("--n-examples", "1000", "--rounds",
                                       "2"),
              "multidc_ablation": ("--n-examples", "1500", "--rounds", "2")}


@contextlib.contextmanager
def timed_runs(torch, module, names, out):
    """Replace each harness function ``module.<name>`` by one that
    synchronises around the call and appends its seconds (and, for a
    co-learning run, its per-round seconds and T) to ``out``."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            row = {"run": name, "seconds": time.perf_counter() - t0}
            if "round_s" in res:
                row.update(round_s=res["round_s"], T=res["T"])
            out.append(row)
            return res
        return timed
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _model_grads(torch, apply_fn, params, x, y):
    """Logits, the harness's loss and the gradients of ``logits.sum()`` and
    of that loss, as one flat list of tensors on the CPU."""
    from repro_torch.paper_tasks.harness import cls_loss
    from repro_torch.tree import leaves
    ps = leaves(params)
    for t in ps:
        t.requires_grad_(True)
    logits = apply_fn(params, x)
    g_sum = torch.autograd.grad(logits.sum(), ps)
    loss, _ = cls_loss(apply_fn)(params, (x, y))
    g_loss = torch.autograd.grad(loss, ps)
    return [t.detach().cpu() for t in (logits, loss, *g_sum, *g_loss)]


def _phase12_models(torch, dev):
    """12(a): the nine models' logits and gradients, card against CPU from
    the same params, with cuDNN's TF32 switched ON globally (PyTorch's
    default): the port keeps its convolutions in f32 itself."""
    from repro_torch.data.synthetic import audio_like, image_like, text_like
    from repro_torch.models import convnets as cn
    from repro_torch.tree import tree_map
    torch.backends.cudnn.allow_tf32 = True
    worst = {}
    try:
        for models, data in ((cn.IMAGE_MODELS, image_like),
                             (cn.TEXT_MODELS, text_like),
                             (cn.AUDIO_MODELS, audio_like)):
            x, y = data(seed=0, n=BATCH12)
            x, y = torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64)
            for name, (init_fn, apply_fn) in models.items():
                params = init_fn(torch.Generator().manual_seed(0))
                want = _model_grads(torch, apply_fn, params, x, y)
                got = _model_grads(torch, apply_fn, tree_map(
                    lambda t: t.detach().to(dev), params), x.to(dev),
                    y.to(dev))
                err = 0.0
                for a, b in zip(got, want):
                    d = (a - b).abs()
                    err = max(err, float(d.max()))
                    check(bool((d <= TOL12["atol"]
                                + TOL12["rtol"] * b.abs()).all()),
                          f"12a: {name} card vs CPU off by {float(d.max())}"
                          f" (tol {TOL12})")
                worst[name] = err
    finally:
        torch.backends.cudnn.allow_tf32 = False
    say("paper-tasks", part="a", models=len(worst), batch=BATCH12,
        tol=TOL12, cudnn_allow_tf32=True, max_abs_err=worst)
    check(len(worst) == 9, f"12a: {len(worst)} models, not 9")


def _phase12_table2(torch, dev):
    """12(b): Table 2 at ``ROUNDS12B`` rounds, then resnet_tiny's
    co-learning run once more through the fused engine."""
    from repro_torch.data.synthetic import image_like
    from repro_torch.models.convnets import IMAGE_MODELS
    from repro_torch.paper_tasks import cifar_like
    runs = []
    torch.cuda.reset_peak_memory_stats()
    with timed_runs(torch, cifar_like, ("run_vanilla", "run_ensemble",
                                        "run_colearn"), runs):
        rows = cifar_like.run(rounds=ROUNDS12B, device=dev)
    peak = torch.cuda.max_memory_allocated()
    check([r["model"] for r in rows] == ["vgg_tiny", "resnet_tiny",
                                         "densenet_tiny"],
          f"12b: Table 2 rows {rows}")
    for r in rows:
        check(all(0.0 <= r[k] <= 1.0 for k in ("vanilla", "ensemble",
                                               "colearn", "local_mean")),
              f"12b: accuracy out of range {r}")
    python = runs[5]                       # resnet_tiny's co-learning run
    # the same run through the fused engine: one round graph per T
    init_fn, apply_fn = IMAGE_MODELS["resnet_tiny"]
    train, test = image_like(0, n=4000), image_like(1000, n=1000)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cifar_like.run_colearn(init_fn, apply_fn, train, test, K=5,
                                 rounds=8, T0=1, epsilon=0.03, seed=0,
                                 engine="fused", device=dev)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_peak = torch.cuda.max_memory_allocated()
    graphs = {f.name: {"captures": f.captures, "replays": f.replays}
              for f in res["learner"]._runner.graphs.functions}
    check(graphs["round"]["captures"] == len(set(res["T"])),
          f"12b: fused round graph {graphs['round']} for T {res['T']}")
    seen, replayed = set(), []
    for i, T in enumerate(res["T"]):
        if T in seen:
            replayed.append(i)
        seen.add(T)
    per_epoch = {eng: [r["round_s"][i] / r["T"][i] for i in replayed
                       if i < len(r["T"])]
                 for eng, r in (("python", python), ("fused", res))}
    say("paper-tasks", part="b", table2=rows, runs=runs,
        reduced=f"rounds 6 -> {ROUNDS12B} (co-learning 8 -> "
                f"{ROUNDS12B + 2}): the time budget",
        peak_mem_GB=peak / 1e9,
        resnet_fused={"seconds": fused_s, "round_s": res["round_s"],
                      "T": res["T"], "acc": res["acc"], "graphs": graphs,
                      "peak_mem_GB": fused_peak / 1e9},
        resnet_python={"round_s": python["round_s"], "T": python["T"],
                       "acc": rows[1]["colearn"]},
        replayed_rounds=replayed, s_per_epoch_replayed=per_epoch)
    del res
    gc.collect()
    torch.cuda.empty_cache()


def _phase12_tasks(torch, dev):
    """12(c): Tables 4-6 (``tasks.run()``, its rounds cut to
    ``ROUNDS12C``) and the heterogeneity sweep
    (``ablation.heterogeneity()``, its rounds cut to ``SWEEP12C``), whose
    shard sizes and coverage equal the committed JAX rows."""
    from repro_torch.paper_tasks import ablation, tasks
    runs = []
    torch.cuda.reset_peak_memory_stats()
    with timed_runs(torch, tasks, ("run_vanilla", "run_colearn"), runs):
        rows = tasks.run(rounds=ROUNDS12C, device=dev)
    check([r["model"] for r in rows] == [
        "gru_text", "transformer_text", "crnn_ap", "crnn_mp", "crnn_sa",
        "crnn_ma"], f"12c: Tables 4-6 rows {rows}")
    peak = torch.cuda.max_memory_allocated()
    say("paper-tasks", part="c-tables", rows=rows, runs=runs,
        reduced=f"rounds 5 -> {ROUNDS12C} (vanilla epochs and co-learning "
                "rounds): the time budget", peak_mem_GB=peak / 1e9)
    gc.collect()
    torch.cuda.empty_cache()
    runs = []
    torch.cuda.reset_peak_memory_stats()
    with timed_runs(torch, ablation, ("run_colearn",), runs):
        het = ablation.heterogeneity(rounds=SWEEP12C, device=dev)
    peak = torch.cuda.max_memory_allocated()
    ref = json.loads((ROOT / "benchmarks" / "BENCH_heterogeneity.json")
                     .read_text())["rows"]
    check(len(het) == len(ref), f"12c: {len(het)} sweep rows")
    for a, b in zip(het, ref):
        check((a["alpha"], a["weighted"], a["shard_sizes"], a["coverage"])
              == (b["alpha"], b["weighted"], b["shard_sizes"],
                  b["coverage"]),
              f"12c: sweep row {a} against the committed {b}")
    say("paper-tasks", part="c-heterogeneity", runs=runs,
        reduced=f"rounds 5 -> {SWEEP12C}: the time budget (the curves "
                "are printed beside the JAX rows' 5, not held)",
        peak_mem_GB=peak / 1e9,
        rows=[{"alpha": a["alpha"], "weighted": a["weighted"],
               "shard_sizes": a["shard_sizes"], "coverage": a["coverage"],
               "final_acc": a["final_acc"], "curve": a["curve"],
               "jax_final_acc": b["final_acc"], "jax_curve": b["curve"]}
              for a, b in zip(het, ref)])
    gc.collect()
    torch.cuda.empty_cache()


def _phase12_kernels(torch, dev, launches_out):
    """12(d): resnet_tiny co-learning rounds through the fused engine under
    the fused int8 codec (K3) and the leaf-wise one (K1 + K2), card
    against CPU from the same params, per round at 1e-4."""
    from repro_torch.data.synthetic import image_like
    from repro_torch.kernels import ops
    from repro_torch.models.convnets import IMAGE_MODELS
    from repro_torch.paper_tasks.harness import run_colearn
    from repro_torch.tree import leaves
    init_fn, apply_fn = IMAGE_MODELS["resnet_tiny"]
    params = init_fn(torch.Generator().manual_seed(0))
    train, test = image_like(0, n=4000), image_like(1000, n=1000)
    K, rounds = 5, 3
    for codec, kernels in CODECS12.items():
        runs = {}
        for d in ("cpu", dev):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs[str(d)] = run_colearn(
                lambda gen: params, apply_fn, train, test, K=K,
                rounds=rounds, T0=1, epsilon=0.03, steps_cap=2,
                engine="fused", codec=codec, device=d)
            if d != "cpu":
                torch.cuda.synchronize()
            runs[str(d)]["seconds"] = time.perf_counter() - t0
            runs[str(d)]["launches"] = ops.launch_counts()
        cpu, card = runs["cpu"], runs[str(dev)]
        check(not any(cpu["launches"].values()), "12d: the CPU run launched")
        worst = 0.0
        for a, b in zip(cpu["state"]["log"], card["state"]["log"]):
            check((a.T, a.comm_bytes) == (b.T, b.comm_bytes),
                  f"12d {codec}: T / comm bytes {a} vs {b}")
            for x, y in [*zip(a.local_losses, b.local_losses),
                         (a.lr_first, b.lr_first), (a.lr_last, b.lr_last),
                         (a.rel_change, b.rel_change)]:
                if math.isinf(x):
                    check(math.isinf(y), "12d: rel inf on one side only")
                    continue
                worst = max(worst, abs(x - y) / max(abs(x), 1e-12))
        check(worst <= 1e-4, f"12d {codec}: card vs CPU logs differ by "
                             f"{worst} (rel)")
        check(cpu["comm_bytes"] == card["comm_bytes"]
              and cpu["total_comm_bytes"] == card["total_comm_bytes"],
              f"12d {codec}: comm bytes differ")
        n_leaves = sum(t.ndim > 0 and t.numel() >= 256
                       for t in leaves(card["state"]["params"]))
        per_round = 1 if codec == "fused" else n_leaves
        counts = card["launches"]
        check(all(counts[k] == rounds * per_round for k in kernels),
              f"12d {codec}: launches {counts}, not {per_round} a round")
        graphs = {f.name: {"captures": f.captures, "replays": f.replays}
                  for f in card["learner"]._runner.graphs.functions}
        for k in kernels:
            launches_out[k] = launches_out.get(k, 0) + counts[k]
        say("paper-tasks", part="d", codec=codec, K=K, rounds=rounds,
            steps_per_epoch=2, log_max_rel_diff=worst,
            comm_bytes=card["comm_bytes"], T=card["T"],
            launches={k: counts[k] for k in kernels}, graphs=graphs,
            seconds={"cpu": cpu["seconds"], "card": card["seconds"]},
            round_s_card=card["round_s"], acc_card=card["acc"],
            acc_cpu=cpu["acc"])
        del runs, cpu, card
        gc.collect()
        torch.cuda.empty_cache()


def phase_paper_tasks(torch, dev, launches_out, mark):
    """Phase 12: the paper's tasks on the card, (a)-(e)."""
    _phase12_models(torch, dev)
    mark("12a")
    _phase12_table2(torch, dev)
    mark("12b")
    _phase12_tasks(torch, dev)
    mark("12c")
    _phase12_kernels(torch, dev, launches_out)
    mark("12d")
    phase_examples(torch, EXAMPLES12, "12e")
    mark("12e")


# ---------------------------------------------------------------------------
@contextlib.contextmanager
def synced_spans(torch, targets):
    """Replace each ``(module, attribute, name)`` function by one that
    synchronises around the call and adds its host seconds to
    ``spans[name]``; restore them on exit."""
    spans = {name: 0.0 for _, _, name in targets}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for (mod, attr, name), (_, _, fn) in zip(targets, saved):
        def timed(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            spans[_name] += time.perf_counter() - t0
            return out
        setattr(mod, attr, timed)
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _prefills(torch, cfg, params, tokens, per_prefill, tag,
              span_targets=(), counters=None):
    """(a) of the serving phases: two prefills through
    ``make_prefill_step(cfg, impl="kernel")``, each kernel of
    ``per_prefill`` ({name: launches}) launched that many times in each;
    the first warms up, the second runs inside
    ``synced_spans(span_targets)``. Returns (seconds, spans, the change of
    ``counters()`` (a dict of counts) in each prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg, impl="kernel")
    seconds, moved = [], []
    for i in range(2):
        before = ops.launch_counts()
        c0 = counters() if counters else {}
        with synced_spans(torch, span_targets if i else ()) as spans:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(params, {"tokens": tokens})
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        c1 = counters() if counters else {}
        moved.append({k: c1[k] - c0[k] for k in c1})
        for kernel, want in per_prefill.items():
            n = after[kernel] - before[kernel]
            check(n == want, f"{tag}a: {kernel} launched {n} times in one "
                             f"prefill, not {want}")
        check(logits.shape == (tokens.shape[0], cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{tag}a: prefill logits not finite or misshapen")
    return seconds, dict(spans), moved


@contextlib.contextmanager
def recorded_layer_decodes(torch, tr, n_layers, shape, dev):
    """Write the input and output of every ``transformer.layer_decode``
    call into ``(n_layers, B, P, D)`` buffers at (layer, the step's
    position): call i of a step is layer i mod n_layers. The position is
    the step's device tensor, so the writes are recorded into a captured
    decode step and made again by each replay. Yields (inputs, outputs)."""
    xs = torch.zeros((n_layers, *shape), device=dev)
    ys = torch.zeros_like(xs)
    calls, fn = [0], tr.layer_decode

    def recorded(p, kind, x, cfg, cache, pos):
        y, cache = fn(p, kind, x, cfg, cache, pos)
        i = calls[0] % n_layers
        calls[0] += 1
        idx = pos.reshape(1).long()
        xs[i].index_copy_(1, idx, x.float())
        ys[i].index_copy_(1, idx, y.float())
        return y, cache
    tr.layer_decode = recorded
    try:
        yield xs, ys
    finally:
        tr.layer_decode = fn


def _layers(cfg, params):
    """(layer params, kind) of every layer, in the order ``forward`` runs
    them."""
    from repro_torch.tree import tree_map
    for seg, (pattern, repeats) in zip(params["segments"], cfg.segments):
        for r in range(repeats):
            for j, kind in enumerate(pattern):
                yield tree_map(lambda t, _r=r: t[_r], seg[f"p{j}"]), kind


def _per_layer(torch, cfg, params, xs, ys, tol, tag):
    """Each layer of the loop's token-by-token prefill (its inputs ``xs``
    and outputs ``ys``, (L, B, P, D)) against ``layer_apply(impl=
    "kernel")`` of that layer on the loop's own inputs to it (all P
    positions at once), at ``tol``. Returns the max error."""
    from repro_torch.models import transformer as tr
    worst = 0.0
    for i, (p, kind) in enumerate(_layers(cfg, params)):
        x = xs[i]
        B, P = x.shape[:2]
        pos = torch.arange(P, dtype=torch.int32, device=x.device)
        want, _ = tr.layer_apply(p, kind, x, cfg, pos.expand(B, P),
                                 "kernel")
        worst = max(worst, _close(torch, ys[i], want, tol,
                                  f"{tag}d: layer {i} ({kind}) of the loop "
                                  "vs layer_apply(impl='kernel')"))
    return worst


def _gaps(ms):
    """A ``generate``'s token gaps (``step_ms``, device ms between
    consecutive decode replays' ends): median, p95, max and count."""
    return {"median": statistics.median(ms),
            "p95": statistics.quantiles(ms, n=20)[-1], "max": max(ms),
            "n": len(ms)}


def _loop_swap(torch, dev, cfg, params, g, tol, tag, bound_ms,
               end_to_end=True, swap=True, batch=8):
    """(b)-(d) of the serving phases: the ``ServeLoop`` at ``batch`` (128 +
    64 tokens, every ``generate`` under the sync guard and with tracing on
    for its token gaps), its decode step captured once, when the loop is
    built, and replayed for every prompt and decode token; (c) with
    ``swap``, a second model published to a ``ModelBank`` and polled in
    (copied into the loop's params, no second capture), whose tokens must
    equal an eager ``decode_step`` loop of it; without (a model too large
    to hold twice), the loop's tokens from (b) against an eager loop of
    the same model. The eager loop is timed beside the captured one, and
    the decode ms a step stands beside ``bound_ms``. (d) the
    token-by-token prefill of a second loop, built with every layer's
    inputs and outputs recorded into its captured step,
    against the kernel prefill at ``tol``: every layer on the same inputs
    and, when ``end_to_end``, the last-prompt logits. Otherwise the
    logits' distance is recorded beside that of ``prefill(impl="ref")``,
    the spread of two f32 orderings of the same model. (d) runs at the
    least drop-free MoE capacity factor, ``ceil(n_experts / top_k)``, where
    the model has experts: which tokens a capacity drops depends on how
    many tokens a call sees. Returns the record."""
    from repro_torch import spans
    from repro_torch.analysis import guards
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ModelBank, ServeLoop
    B, P, new, max_seq = batch, 128, 64, 256
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = ServeLoop(cfg, params, batch=B, max_seq=max_seq, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(loop.compile_count() == 1 and loop.replay_count() == 0,
          f"{tag}b: building the loop did not capture its step once")
    stats, replays = [], []

    def served(prompts, new):
        before = loop.replay_count()
        spans.enable()                  # generate's step_ms: the token gaps
        try:
            with guards.no_transfer(dev):
                gen, st = loop.generate(prompts, new)
        finally:
            spans.disable()
        replays.append(loop.replay_count() - before)
        check(replays[-1] == prompts.shape[1] + new,
              f"{tag}b: {replays[-1]} replays in a generate of "
              f"{prompts.shape[1]} + {new} tokens")
        return gen, st

    served(prompts[:, :8], 4)                               # warm-up
    torch.cuda.reset_peak_memory_stats()
    gen0, st0 = served(prompts, new)
    peak_loop = torch.cuda.max_memory_allocated()
    stats.append(st0)

    # (c) the loop's tokens against an eager decode loop of the model it
    # serves: a second model through the bank, or the same one
    params1, gen1 = params, gen0
    if swap:
        params1 = tr.init_params(1, cfg, torch.float32, device=dev)
        bank = ModelBank()
        bank.publish(params1, round_i=1)
        check(loop.poll(bank) and loop.version == 1,
              f"{tag}c: poll did not swap")
        gen1, st1 = served(prompts, new)
        stats.append(st1)
        del bank
    check(loop.compile_count() == 1 and all(
        x["compile_count"] == 1 for x in stats),
        f"{tag}c: the loop captured its step {loop.compile_count()} times")
    captures, total_replays = loop.compile_count(), loop.replay_count()
    del loop
    gc.collect()                # a GraphSet and its functions form a cycle
    torch.cuda.empty_cache()
    cache = tr.init_cache(cfg, B, max_seq, torch.float32, dev)
    pos = torch.arange(max_seq, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = tr.decode_step(params1, cfg, cache,
                                       prompts[:, t:t + 1], pos[t])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok, eager = torch.argmax(logits, -1), []
    for i in range(new):
        eager.append(tok)
        logits, cache = tr.decode_step(params1, cfg, cache, tok, pos[P + i])
        tok = torch.argmax(logits, -1)
    eager = torch.cat(eager, dim=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    what = "after the swap " if swap else ""
    check(torch.equal(gen1, eager), f"{tag}c: ServeLoop tokens {what}differ "
                                    "from an eager decode loop")
    if swap:
        check(not torch.equal(gen1, gen0), f"{tag}c: the swapped model "
                                           "generates the first model's "
                                           "tokens")
    del cache, eager

    # (d) the loop's token-by-token prefill against the kernel prefill
    cfg_d = cfg
    if cfg.n_experts:
        cfg_d = cfg.with_(capacity_factor=float(-(-cfg.n_experts
                                                   // cfg.top_k)))
    with recorded_layer_decodes(torch, tr, cfg_d.n_layers,
                                (B, P, cfg.d_model), dev) as (xs, ys):
        loop_d = ServeLoop(cfg_d, params1, batch=B, max_seq=max_seq,
                           device=dev)
        loop_logits, _ = loop_d.prefill(prompts)
    check(loop_d.compile_count() == 1 and loop_d.replay_count() == P,
          f"{tag}d: the recording loop captured {loop_d.compile_count()} "
          f"times and replayed {loop_d.replay_count()} times for {P} "
          "prompt tokens")
    del loop_d
    gc.collect()
    d = {"per_layer_max_abs_err": _per_layer(torch, cfg_d, params1, xs, ys,
                                             tol, tag)}
    if cfg.n_experts:
        d["capacity_factor"] = cfg_d.capacity_factor
    del xs, ys
    want = tr.prefill(params1, cfg_d, {"tokens": prompts}, impl="kernel")
    if end_to_end:
        d["logits_max_abs_err"] = _close(
            torch, loop_logits[:, 0], want, tol,
            f"{tag}d: ServeLoop prefill vs prefill(impl='kernel')")
    else:
        ref = tr.prefill(params1, cfg_d, {"tokens": prompts}, impl="ref")
        d["logits_max_abs_diff"] = {
            "loop_vs_kernel": float((loop_logits[:, 0] - want).abs().max()),
            "loop_vs_ref": float((loop_logits[:, 0] - ref).abs().max()),
            "kernel_vs_ref": float((want - ref).abs().max()),
            "logits_max_abs": float(want.abs().max())}
        del ref
    peak = torch.cuda.max_memory_allocated()
    del params1, want, loop_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"loop": {"prompt_len": P, "new_tokens": new, "max_seq": max_seq,
                     "build_and_capture_s": build_s,
                     "prefill_s": [x["prefill_s"] for x in stats],
                     "decode_s": [x["decode_s"] for x in stats],
                     "decode_ms_per_step": [1e3 * x["decode_s"] / new
                                            for x in stats],
                     "token_gap_ms": [_gaps(x["step_ms"]) for x in stats],
                     "bound_ms_per_step": bound_ms,
                     "decode_tokens_per_s": [x["tokens_per_s"]
                                             for x in stats],
                     "prompt_tokens_per_s": [B * P / x["prefill_s"]
                                             for x in stats],
                     "peak_mem_GB": peak_loop / 1e9,
                     "captures": captures,
                     "replays_per_generate": replays,
                     "replays": total_replays,
                     "versions": [x["version"] for x in stats]},
            "eager_loop": {"prompt_s": t1 - t0, "decode_s": t2 - t1,
                           "decode_ms_per_step": 1e3 * (t2 - t1) / new,
                           "decode_tokens_per_s": B * new / (t2 - t1)},
            ("swap_tokens_equal_eager" if swap else "tokens_equal_eager"):
                True,
            "loop_vs_prefill": d, "tol": tol, "peak_mem_GB": peak / 1e9}


def phase_serving(torch, dev, launches_out, k5_ms, bw):
    """Phase 6: prefill through K5 (K5's synchronised span in the second),
    the ServeLoop, a hot swap from a ModelBank, at internlm2-1.8b's full
    width and all 24 layers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    cfg = get_config("internlm2-1.8b")
    g = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    n_params = tr.count_params(params)
    B, S = 8, 2048
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    weight_bytes = decode_weight_bytes(params, cfg, B)
    ops.reset_launch_counts()
    prefill_s, spans, _ = _prefills(torch, cfg, params, tokens,
                                    {"flash_attention": cfg.n_layers}, "6",
                                    span_targets=[(ops, "flash_attention",
                                                   "k5")])
    peak_prefill = torch.cuda.max_memory_allocated()
    del tokens
    torch.cuda.empty_cache()
    rec = _loop_swap(torch, dev, cfg, params, g,
                     {"rtol": 1e-4, "atol": 1e-4}, "6",
                     1e3 * weight_bytes / bw)
    counts = ops.launch_counts()
    check(counts["flash_attention"] == 4 * cfg.n_layers,
          f"6: K5 launched {counts['flash_attention']} times over four "
          "prefills (two in (a), one by layer and one whole in (d))")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    say("serving", model=cfg.name, n_layers=cfg.n_layers,
        params=n_params, dtype="float32", batch=B,
        prefill={"seq_len": S, "seconds": prefill_s,
                 "tokens_per_s": [B * S / x for x in prefill_s],
                 "k5_launches_per_prefill": cfg.n_layers,
                 "spans_s_second_prefill": spans,
                 "k5_share_second_prefill": spans["k5"] / prefill_s[1],
                 "k5_share_from_phase3_ms": cfg.n_layers * k5_ms / 1e3
                 / prefill_s[0],
                 "peak_mem_GB": peak_prefill / 1e9},
        decode_weight_GB=weight_bytes / 1e9,
        decode_bound_ms_per_step=1e3 * weight_bytes / bw,
        launches=counts, **rec)
    del params
    torch.cuda.empty_cache()


def decode_weight_bytes(params, cfg, batch):
    """f32 bytes of weights one decode step must read: every weight once,
    but of an untied input embedding table only the batch's rows."""
    from repro_torch.models import transformer as tr
    n = tr.count_params(params)
    if not cfg.tie_embeddings:
        n -= params["embed"]["table"].numel() - batch * cfg.d_model
    return 4 * n


def routed_weight_bytes(params, cfg, batch):
    """``decode_weight_bytes`` with, of each MoE layer's routed experts,
    only the ``min(E, batch * top_k)`` that the batch's choices can reach:
    the least a decode step needs, where the capacity dispatch reads all
    E experts' weights."""
    from repro_torch.tree import leaves_with_path
    named = [(path.rsplit("/", 1), t)
             for path, t in leaves_with_path(params)]
    moes = {parent for (parent, name), _ in named if name == "router"}
    routed = sum(t.numel() for (parent, name), t in named
                 if parent in moes and name in ("wi", "wg", "wo"))
    E = cfg.n_experts
    unused = E - min(E, batch * cfg.top_k) if E else 0
    return (decode_weight_bytes(params, cfg, batch)
            - 4 * routed * unused // max(E, 1))


def phase_xlstm_serving(torch, dev, launches_out, k7_ms, bw):
    """Phase 7: xlstm-1.3b at full width and all 48 layers: prefill through
    K7 (with the time split between mLSTM layers, K7 and sLSTM layers),
    the ServeLoop over the recurrent state, a hot swap."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr, xlstm as xl
    cfg = get_config("xlstm-1.3b")
    n_mlstm = sum(kind.startswith("mlstm") for kind in cfg.layer_kinds())
    g = torch.Generator(device=dev).manual_seed(8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    n_params = tr.count_params(params)
    B, S = 8, 2048
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    n_slstm = cfg.n_layers - n_mlstm
    # f32 decode state: C, n, m per mLSTM layer; h, c, n, m per sLSTM layer
    H, d = cfg.n_heads, cfg.d_model
    hd = int(cfg.xlstm_proj_factor * d) // H
    state_bytes = 4 * B * H * (n_mlstm * (hd * hd + hd + 1)
                               + n_slstm * 4 * (d // H))
    weight_bytes = decode_weight_bytes(params, cfg, B)
    bound_ms = 1e3 * (weight_bytes + 2 * state_bytes) / bw
    xl.release_slstm_graphs()
    ops.reset_launch_counts()
    prefill_s, spans, slstm_moved = _prefills(
        torch, cfg, params, tokens, {"mlstm": n_mlstm}, "7",
        span_targets=[(xl, "mlstm_apply", "mlstm_layers"),
                      (ops, "mlstm", "k7"),
                      (xl, "slstm_apply", "slstm_layers")],
        counters=xl.slstm_graph_counts)
    # the sLSTM recurrence: one graph for the six layers at this shape,
    # captured in the first prefill, replayed by every layer of the second
    check([m["captures"] for m in slstm_moved] == [1, 0]
          and slstm_moved[1]["replays"] == n_slstm,
          f"7a: sLSTM graph captures / replays per prefill {slstm_moved}, "
          f"not one capture and {n_slstm} replays in the second")
    peak_prefill = torch.cuda.max_memory_allocated()
    del tokens
    torch.cuda.empty_cache()
    rec = _loop_swap(torch, dev, cfg, params, g, ML_TOL, "7", bound_ms,
                     end_to_end=False)
    slstm_phase = xl.slstm_graph_counts()
    check(slstm_phase["captures"] == 2,
          f"7: {slstm_phase['captures']} sLSTM captures, not one per "
          "prefill shape (8 x 2048 in (a), 8 x 128 in (d))")
    xl.release_slstm_graphs()
    counts = ops.launch_counts()
    check(counts["mlstm"] == 4 * n_mlstm,
          f"7: K7 launched {counts['mlstm']} times over four prefills (two "
          "in (a), one by layer and one whole in (d))")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    say("xlstm-serving", model=cfg.name, n_layers=cfg.n_layers,
        mlstm_layers=n_mlstm, params=n_params, dtype="float32", batch=B,
        prefill={"seq_len": S, "seconds": prefill_s,
                 "tokens_per_s": [B * S / x for x in prefill_s],
                 "k7_launches_per_prefill": n_mlstm,
                 "spans_s_second_prefill": spans,
                 "k7_share_second_prefill": spans["k7"] / prefill_s[1],
                 "k7_share_from_phase3_ms": n_mlstm * k7_ms / 1e3
                 / prefill_s[0],
                 "slstm_graphs_per_prefill": slstm_moved,
                 "slstm_span_s_second_prefill": spans["slstm_layers"],
                 "peak_mem_GB": peak_prefill / 1e9},
        slstm_graphs_phase=slstm_phase,
        decode_state_GB=state_bytes / 1e9,
        decode_bound_ms_per_step=bound_ms, launches=counts, **rec)
    del params
    torch.cuda.empty_cache()


def jamba_cfg():
    """jamba-v0.1-52b at full width, one 8-layer period of its published
    interleave (the config's ``_PERIOD``) in place of four."""
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_v0_1_52b import _PERIOD
    return get_config("jamba-v0.1-52b").with_(n_layers=len(_PERIOD),
                                              segments=((_PERIOD, 1),))


def phase_jamba_serving(torch, dev, launches_out, k6_ms, bw):
    """Phase 8: jamba-v0.1-52b at full width, one period: prefill through
    K6 and K5 (the time split between Mamba layers, K6, MoE FFNs, dense
    FFNs and the attention layer), the ServeLoop over the Mamba state and
    KV cache, its tokens against an eager decode loop of the same model
    (two f32 copies of the 53 GB model do not fit, so no swap)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn, mamba as mam, \
        moe as moe_mod, transformer as tr
    cfg = jamba_cfg()
    kinds = cfg.layer_kinds()
    n_mamba = sum(kind.startswith("mamba") for kind in kinds)
    n_attn = sum(kind.startswith("gqa") for kind in kinds)
    g = torch.Generator(device=dev).manual_seed(9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    n_params = tr.count_params(params)
    peak_init = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    B, S = 8, 2048
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    # decode state at batch 8: a conv tail and an f32 SSM state per Mamba
    # layer, the KV cache of the attention layer
    di, st, K = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.ssm_conv_dim
    state_bytes = 4 * B * (n_mamba * ((K - 1) * di + di * st)
                           + n_attn * 2 * 256 * cfg.n_kv_heads
                           * cfg.head_dim)
    bound_ms = 1e3 * (decode_weight_bytes(params, cfg, B)
                      + 2 * state_bytes) / bw
    ops.reset_launch_counts()
    prefill_s, spans, _ = _prefills(
        torch, cfg, params, tokens,
        {"selective_scan": n_mamba, "flash_attention": n_attn}, "8",
        span_targets=[(mam, "mamba_apply", "mamba_layers"),
                      (ops, "selective_scan", "k6"),
                      (moe_mod, "moe_apply", "moe_ffns"),
                      (tr, "ffn_apply", "dense_ffns"),
                      (attn, "attn_apply", "attention_layer"),
                      (ops, "flash_attention", "k5")])
    peak_prefill = torch.cuda.max_memory_allocated()
    del tokens
    torch.cuda.empty_cache()
    rec = _loop_swap(torch, dev, cfg, params, g,
                     {"rtol": 1e-4, "atol": 1e-4}, "8", bound_ms,
                     swap=False)
    counts = ops.launch_counts()
    check(counts["selective_scan"] == 4 * n_mamba
          and counts["flash_attention"] == 4 * n_attn,
          f"8: K6 launched {counts['selective_scan']} and K5 "
          f"{counts['flash_attention']} times over four prefills (two in "
          "(a), one by layer and one whole in (d))")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    say("jamba-serving", model=cfg.name, n_layers=cfg.n_layers,
        layer_kinds=kinds,
        reduced="n_layers 32 -> 8: one period of the published interleave;"
                " 52 B values do not fit one card",
        params=n_params, dtype="float32", batch=B,
        capacity_factor=cfg.capacity_factor,
        init_peak_mem_GB=peak_init / 1e9,
        prefill={"seq_len": S, "seconds": prefill_s,
                 "tokens_per_s": [B * S / x for x in prefill_s],
                 "k6_launches_per_prefill": n_mamba,
                 "k5_launches_per_prefill": n_attn,
                 "spans_s_second_prefill": spans,
                 "k6_share_from_phase3_ms": n_mamba * k6_ms / 1e3
                 / prefill_s[1],
                 "k5_share_second_prefill": spans["k5"] / prefill_s[1],
                 "peak_mem_GB": peak_prefill / 1e9},
        decode_state_GB=state_bytes / 1e9,
        decode_bound_ms_per_step=bound_ms, launches=counts, **rec)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Phase 13: the six architectures ported last
# ---------------------------------------------------------------------------
# 13(a)/(b): deepseek-v3-671b and arctic-480b at full width, cut in depth
# to what fits one card in f32 (their MoE leaves are the largest single
# tensors the port makes: 15.0 and 17.8 GB). (c): qwen2-72b and
# internvl2-76b at full width, 2 of 80 layers. Prefill batches and the
# loop's batch per model.
LAYERS13 = 2
B13_DEEPSEEK, B13_ARCTIC, B13_DENSE, S13 = 4, 8, 8, 2048
LOOP_B13 = 4
SMOKE13 = ("qwen1.5-32b", "qwen2-72b", "musicgen-large", "internvl2-76b",
           "arctic-480b", "deepseek-v3-671b")
TOL13 = {"rtol": 1e-4, "atol": 1e-4}


def deepseek13_cfg():
    """deepseek-v3-671b at full width: one ``mla:dense`` and one
    ``mla:moe`` layer (the segment structure kept), no MTP head."""
    from repro_torch.configs import get_config
    return get_config("deepseek-v3-671b").with_(
        n_layers=2, segments=((("mla:dense",), 1), (("mla:moe",), 1)),
        mtp_depth=0)


def arctic13_cfg():
    """arctic-480b at full width: one ``gqa:moe_dense`` layer."""
    from repro_torch.configs import get_config
    return get_config("arctic-480b").with_(
        n_layers=1, segments=((("gqa:moe_dense",), 1),))


def _init13(torch, cfg, dev):
    """Init at full width -> (params, record): seconds, values, bytes, the
    largest leaf and the allocator's peak during init, which the in-place
    ``trunc_normal`` holds to the params plus at most one leaf."""
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = tr.count_params(params)
    leaf = max(t.numel() for t in leaves(params))
    peak = torch.cuda.max_memory_allocated() - base
    check(peak <= 4 * (n + leaf),
          f"13: init of {cfg.name} peaked at {peak / 1e9:.2f} GB over "
          f"{4 * n / 1e9:.2f} GB of params (largest leaf "
          f"{4 * leaf / 1e9:.2f} GB)")
    return params, {"params": n, "params_GB": 4 * n / 1e9,
                    "largest_leaf_GB": 4 * leaf / 1e9, "init_s": init_s,
                    "init_peak_mem_GB": peak / 1e9}


def _serve13(torch, dev, launches_out, bw, cfg, tag, B, seed, reduced,
             span_targets, per_prefill, cache_floats):
    """13(a)/(b): a full-width MoE model cut in depth: two prefills of
    B x 2048 through ``make_prefill_step(impl="kernel")`` (the second with
    synchronised spans), then the ``ServeLoop`` (batch ``LOOP_B13``, 128 +
    64 tokens) against an eager loop of the same model (two copies do not
    fit: no swap) and the loop's prefill against the kernel prefill at a
    drop-free factor. Decode stands beside two bounds: every weight once
    (``decode_weight_bytes``: the capacity dispatch reads every expert)
    and the routed one (``routed_weight_bytes``). ``cache_floats``: the
    decode cache's f32 floats per token and layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    g = torch.Generator(device=dev).manual_seed(seed)
    params, init = _init13(torch, cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.randint(0, cfg.vocab_size, (B, S13), generator=g,
                           device=dev)
    n_layers = cfg.n_layers
    state_bytes = 4 * LOOP_B13 * 256 * cache_floats * n_layers
    bound_ms = 1e3 * (decode_weight_bytes(params, cfg, LOOP_B13)
                      + 2 * state_bytes) / bw
    routed_bytes = routed_weight_bytes(params, cfg, LOOP_B13)
    routed_ms = 1e3 * (routed_bytes + 2 * state_bytes) / bw
    ops.reset_launch_counts()
    prefill_s, spans, _ = _prefills(torch, cfg, params, tokens, per_prefill,
                                    tag, span_targets=span_targets)
    peak_prefill = torch.cuda.max_memory_allocated()
    del tokens
    torch.cuda.empty_cache()
    rec = _loop_swap(torch, dev, cfg, params, g, TOL13, tag, bound_ms,
                     swap=False, batch=LOOP_B13)
    counts = ops.launch_counts()
    for kernel, n in per_prefill.items():
        check(counts[kernel] == 4 * n,
              f"{tag}: {kernel} launched {counts[kernel]} times over four "
              f"prefills, not {4 * n}")
    for name, n in counts.items():
        launches_out[name] = launches_out.get(name, 0) + n
    out = dict(model=cfg.name, part=tag.rstrip("/"), n_layers=n_layers,
               layer_kinds=cfg.layer_kinds(), reduced=reduced,
               dtype="float32", batch=B, **init,
               capacity_factor=cfg.capacity_factor,
               prefill={"seq_len": S13, "seconds": prefill_s,
                        "tokens_per_s": [B * S13 / x for x in prefill_s],
                        "launches_per_prefill": per_prefill,
                        "spans_s_second_prefill": spans,
                        "span_shares_second_prefill": {
                            k: v / prefill_s[1] for k, v in spans.items()},
                        "peak_mem_GB": peak_prefill / 1e9},
               decode_cache_floats_per_token_layer=cache_floats,
               decode_state_GB=state_bytes / 1e9,
               decode_bound_ms_per_step=bound_ms,
               decode_routed_weight_GB=routed_bytes / 1e9,
               decode_routed_bound_ms_per_step=routed_ms,
               decode_ms_over_routed_bound=[
                   x / routed_ms for x in rec["loop"]["decode_ms_per_step"]],
               launches=counts, **rec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _phase13_dense(torch, dev, launches_out, arch, seed):
    """13(c): ``arch`` at full width, 2 of 80 layers: a prefill of 8 x
    2048 through K5 (one launch a layer), held against the plain prefill
    on the card at ``TOL13``; internvl2's batch is 256 prefix embeddings
    and 1,792 tokens (S = 2048, as the reference's input specs split it).
    """
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    full = get_config(arch)
    cfg = full.with_(n_layers=LAYERS13,
                     segments=((full.segments[0][0], LAYERS13),))
    g = torch.Generator(device=dev).manual_seed(seed)
    params, init = _init13(torch, cfg, dev)
    if cfg.qkv_bias:                      # zeros at init: give them values
        for seg in params["segments"]:
            for layer in seg.values():
                for name in ("bq", "bk", "bv"):
                    layer["mixer"][name].normal_(0.0, 0.5, generator=g)
    torch.cuda.reset_peak_memory_stats()
    P = cfg.prefix_len if cfg.input_mode == "tokens+prefix" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B13_DENSE, S13 - P),
                                     generator=g, device=dev)}
    if P:
        batch["prefix"] = torch.randn((B13_DENSE, P, cfg.d_model),
                                      generator=g, device=dev)
    secs = {}
    logits = {}
    for impl in ("kernel", "ref", "kernel"):
        before = ops.launch_counts()["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[impl] = make_prefill_step(cfg, impl=impl)(params, batch)
        torch.cuda.synchronize()
        secs.setdefault(impl, []).append(time.perf_counter() - t0)
        n = ops.launch_counts()["flash_attention"] - before
        want = cfg.n_layers if impl == "kernel" else 0
        check(n == want, f"13c {arch}: K5 launched {n} times in a "
                         f"{impl} prefill, not {want}")
        launches_out["flash_attention"] = (
            launches_out.get("flash_attention", 0) + n)
    check(tuple(logits["kernel"].shape) == (B13_DENSE, cfg.vocab_size)
          and bool(torch.isfinite(logits["kernel"]).all()),
          f"13c {arch}: prefill logits not finite or misshapen")
    err = _close(torch, logits["kernel"], logits["ref"], TOL13,
                 f"13c {arch}: kernel prefill vs plain prefill")
    out = dict(model=cfg.name, part="c", n_layers=cfg.n_layers,
               reduced=f"n_layers {full.n_layers} -> {cfg.n_layers}",
               dtype="float32", batch=B13_DENSE, seq_len=S13, prefix_len=P,
               qkv_bias=cfg.qkv_bias,
               k5_shape=[B13_DENSE, S13, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim], **init,
               prefill_s=secs, tokens_per_s={
                   k: [B13_DENSE * S13 / x for x in v]
                   for k, v in secs.items()},
               kernel_vs_plain_max_abs_err=err,
               logits_max_abs=float(logits["ref"].abs().max()),
               peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9, tol=TOL13)
    del params, batch, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _phase13_smoke(torch, dev):
    """13(d): the six smoke configs, card against CPU from the same params
    at ``TOL13``: the loss (the MTP and aux losses in it) and every
    gradient, then 6 ``decode_step`` logits over a fresh cache."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, tree_map
    worst = {}
    for arch in SMOKE13:
        cfg = get_smoke_config(arch)
        cpu = tr.init_params(0, cfg, torch.float32, device="cpu")
        rng = np.random.default_rng(0)
        P = cfg.prefix_len if cfg.input_mode == "tokens+prefix" else 0
        b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (2, P + 16))}
        b["labels"][:, :P] = -1
        if P:
            b["prefix"] = rng.standard_normal((2, P, cfg.d_model)).astype(
                np.float32)
        res = {}
        for where in ("cpu", dev):
            ps = (cpu if where == "cpu" else
                  tree_map(lambda t: t.detach().to(dev), cpu))
            flat = [t.requires_grad_(True) for t in leaves(ps)]
            tb = {k: torch.as_tensor(v, device=where) for k, v in b.items()}
            loss, m = tr.loss_fn(ps, cfg, tb)
            grads = torch.autograd.grad(loss, flat)
            with torch.no_grad():
                cache = tr.init_cache(cfg, 2, 8, torch.float32, where)
                dec = []
                for t in range(6):
                    lg, _ = tr.decode_step(ps, cfg, cache,
                                           tb["tokens"][:, t:t + 1],
                                           torch.tensor(t, device=where))
                    dec.append(lg)
            res[str(where)] = [x.detach().cpu() for x in
                               (loss, *m.values(), *grads, *dec)]
        err = 0.0
        for a, w in zip(res[str(dev)], res["cpu"]):
            err = max(err, _close(torch, a, w, TOL13,
                                  f"13d {arch}: card vs CPU"))
        worst[arch] = err
        check("mtp_loss" in m if cfg.mtp_depth else True,
              f"13d {arch}: no MTP loss")
    return {"part": "d", "archs": list(SMOKE13), "tol": TOL13,
            "max_abs_err": worst}


def _phase13_cli(torch):
    """13(e): the train CLI on the card, fused engine (its default), 2
    rounds each for deepseek-v3-671b (MLA, MoE and the MTP loss inside
    the captured epochs) and arctic-480b; internvl2-76b stops before its
    first round, naming the prefix its batches would need."""
    import io
    from repro_torch.launch import train
    args = ["--device", "cuda", "--participants", "2", "--rounds", "2",
            "--t0", "1", "--n-examples", "32", "--batch-size", "4",
            "--seq-len", "16", "--steps-per-epoch", "2"]
    runs = {}
    for arch in ("deepseek-v3-671b", "arctic-480b"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(args + ["--arch", arch])
        lines = buf.getvalue().splitlines()
        rounds = [x for x in lines if x.startswith("round ")]
        runs[arch] = {"rc": rc, "seconds": time.perf_counter() - t0,
                      "lines": lines}
        check(rc == 0 and len(rounds) == 2 and "engine=fused" in lines[0]
              and all("nan" not in x for x in rounds),
              f"13e {arch}: rc {rc}, lines {lines}")
    err = io.StringIO()
    code = None
    with contextlib.redirect_stderr(err):
        try:
            train.main(args + ["--arch", "internvl2-76b"])
        except SystemExit as e:
            code = e.code
    runs["internvl2-76b"] = {"exit": code, "stderr": err.getvalue()}
    check(code == 2 and "'prefix'" in err.getvalue(),
          f"13e: internvl2-76b did not stop on its prefix: {code}, "
          f"{err.getvalue()}")
    return {"part": "e", "runs": runs}


def phase_new_archs(torch, dev, launches_out, bw, mark):
    """Phase 13: the six architectures ported last (see the docstring)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn, mla as mla_mod, \
        moe as moe_mod, transformer as tr
    cfg = deepseek13_cfg()
    say("new-archs", **_serve13(
        torch, dev, launches_out, bw, cfg, "13a/", B13_DEEPSEEK, 13,
        "n_layers 61 -> 2 (one mla:dense, one mla:moe: the segment "
        "structure kept); mtp_depth 1 -> 0 for the served copy (only "
        "loss_fn reads the MTP head, whose own mla:moe layer, 11.5 B "
        "values, does not fit beside the model in f32)",
        [(mla_mod, "mla_apply", "mla_layers"),
         (mla_mod, "chunked_attention", "latent_attention"),
         (moe_mod, "moe_apply", "moe_ffns"),
         (tr, "ffn_apply", "dense_ffns")],
        {"flash_attention": 0}, cfg.kv_lora_rank + cfg.qk_rope_dim),
        mha_cache_floats_per_token_layer=cfg.n_heads * (
            cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim))
    mark("13a")
    cfg = arctic13_cfg()
    say("new-archs", **_serve13(
        torch, dev, launches_out, bw, cfg, "13b/", B13_ARCTIC, 14,
        "n_layers 35 -> 1 (one gqa:moe_dense layer); 480 B values do not "
        "fit one card",
        [(attn, "attn_apply", "attention_layer"),
         (ops, "flash_attention", "k5"),
         (moe_mod, "moe_apply", "moe_ffns"),
         (tr, "ffn_apply", "dense_ffn")],
        {"flash_attention": 1}, 2 * cfg.n_kv_heads * cfg.head_dim))
    mark("13b")
    for arch, seed in (("qwen2-72b", 15), ("internvl2-76b", 16)):
        say("new-archs", **_phase13_dense(torch, dev, launches_out, arch,
                                          seed))
    mark("13c")
    say("new-archs", **_phase13_smoke(torch, dev))
    mark("13d")
    say("new-archs", **_phase13_cli(torch))
    mark("13e")


# ---------------------------------------------------------------------------
# phase 14: training the recurrent families. (a) xlstm-1.3b at full width,
# depth 48 -> LAYERS14 (1 mLSTM + 1 sLSTM), B 2 x S 512 so
# that every recurrence runs two 256-step chunks (``layers.chunked_scan``:
# the backward pass keeps the carries at the chunk boundaries and
# recomputes each chunk), K 2, fused int8, T 1, one step an epoch; (b) one
# jamba-v0.1-52b ``mamba:dense`` layer at full width, B 4 x S 2048; (c)
# the smoke configs card vs CPU at S 512; (d) the train CLI.
# depth 2 (1 mLSTM + 1 sLSTM; 4 before phase 17 was added) of the
# 8-layer xLSTM[7:1] period: 14(a)'s
# eager rounds and capture are host-bound, ~60 us a graph node, and took
# 374.0 s at depth 8 on a host where the whole script took 1,435 s
# (NVIDIA H100 80GB HBM3, 700 W); phase 16 took that time
LAYERS14 = 2
# K 2 (3 before): the python engine's rounds are host-bound and grow
# with K (the fused engine's capture does not: it batches the K rows;
# 14(a) took 60.5 s at K 3 where the whole script took 808.4 s, NVIDIA
# H100 80GB HBM3, 700 W)
K14, B14, S14, STEPS14 = 2, 2, 512, 1
PY_ROUNDS14, FUSED_ROUNDS14 = 2, 3
B14B, S14B = 4, 2048
S14C, K14C = 512, 2
TOL14 = {"rtol": 1e-4, "atol": 1e-4}
REMAT_TOL14 = 1e-6
# 14(a) trains without per-layer recomputation (the CLI's default is on):
# with it each round records about a fifth more graph nodes and runs its
# eager rounds a forward longer, host-bound at ~60 us a node, which the
# script's clock does not hold; 16(b) measures xlstm's step with it on
REMAT14 = False


def xlstm14_cfg():
    """xlstm-1.3b at full width, ``LAYERS14`` of its 48 layers: the
    xLSTM[7:1] period's mLSTM layers cut to ``LAYERS14 - 1``, then its
    sLSTM layer."""
    from repro_torch.configs import get_config
    return get_config("xlstm-1.3b").with_(
        n_layers=LAYERS14,
        segments=((("mlstm:-",) * (LAYERS14 - 1) + ("slstm:-",), 1),))


def jamba14_cfg():
    """jamba-v0.1-52b at full width, one ``mamba:dense`` layer."""
    from repro_torch.configs import get_config
    return get_config("jamba-v0.1-52b").with_(
        n_layers=1, segments=((("mamba:dense",), 1),))


@contextlib.contextmanager
def graph_stats(torch, out):
    """Every CUDA graph captured inside: the seconds of its recording (from
    ``capture_begin`` to ``capture_end``), of ending the capture and of
    instantiating it, apart (``keep_graph=True``), and its node count
    (``cuGraphGetNodes`` on the raw graph)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    base = torch.cuda.CUDAGraph

    class Counted(base):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

        def capture_begin(self, *a, **kw):
            self._t0 = time.perf_counter()
            super().capture_begin(*a, **kw)

        def capture_end(self):
            t1 = time.perf_counter()
            super().capture_end()
            t2 = time.perf_counter()
            n = ctypes.c_size_t(0)
            rc = cu.cuGraphGetNodes(ctypes.c_void_p(self.raw_cuda_graph()),
                                    None, ctypes.byref(n))
            self.instantiate()
            out.append({"record_s": t1 - self._t0, "end_capture_s": t2 - t1,
                        "instantiate_s": time.perf_counter() - t2,
                        "nodes": n.value if rc == 0 else None})
    torch.cuda.CUDAGraph = Counted
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


@contextlib.contextmanager
def remat_off():
    """The recurrences' ``chunked_scan`` with ``remat=False`` (a plain
    loop that keeps every step for the backward pass)."""
    import functools
    from repro_torch.models import layers, mamba, xlstm
    saved = [(m, m.chunked_scan) for m in (mamba, xlstm)]
    for m, _ in saved:
        m.chunked_scan = functools.partial(layers.chunked_scan, remat=False)
    try:
        yield
    finally:
        for m, fn in saved:
            m.chunked_scan = fn


def _train14(torch, dev, cfg, engine, rounds, launches_out):
    """14(a): one run at full width, without per-layer recomputation
    (``REMAT14``). Returns (per-round records, the run's record)."""
    from repro_torch.core import api
    from repro_torch.data.synthetic import lm_examples
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (build_data, epoch_batches_fn,
                                          eval_loss)
    from repro_torch.models import transformer as tr
    data = build_data(cfg, K14, B14, S14, K14 * B14 * STEPS14, seed=0)
    ex, ey = lm_examples(99, 4, S14, cfg.vocab_size)
    learner = _learner(torch, cfg, api.get_codec("fused"), K14, dev,
                       engine=engine, rounds=rounds, rule="fle",
                       remat=REMAT14)
    split = _round_events(torch, learner)
    guard, stats = [], []
    if engine == "fused":
        timed = learner._runner._round

        def guarded(*a):
            guard.append(torch.cuda.get_sync_debug_mode())
            return timed(*a)
        learner._runner._round = guarded
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    batches = epoch_batches_fn(data, dev, STEPS14)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    per_round = []
    with graph_stats(torch, stats):
        for _ in range(rounds):
            t0 = time.perf_counter()
            state = learner.run_round(state, batches)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            epochs_ms, fin_ms = split()
            log = state["log"][-1]
            per_round.append({
                "round": log.round, "T": log.T, "seconds": sec,
                "tokens_per_s": K14 * STEPS14 * B14 * S14 * log.T / sec,
                "device_ms": {"epochs": epochs_ms, "finalize": fin_ms},
                "local_losses": list(log.local_losses),
                "rel_change": log.rel_change,
                "comm_MiB": log.comm_bytes / 2**20,
                "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    counts = ops.launch_counts()
    ev = eval_loss(learner.shared_model(state), cfg, ex, ey, batch=2)
    run = {"engine": engine, "rounds": per_round, "eval_loss": ev,
           "launches": {k: v for k, v in counts.items() if v},
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_GB": torch.cuda.max_memory_reserved() / 1e9,
           "params_per_participant": tr.count_params(state["params"]) // K14}
    if engine == "fused":
        run.update(graphs={f.name: {"captures": f.captures,
                                    "replays": f.replays}
                           for f in learner._runner.graphs.functions},
                   window_sync_debug_modes=guard, capture=stats)
        for name, n in counts.items():
            launches_out[name] = launches_out.get(name, 0) + n
    check(all(math.isfinite(x) for r in per_round for x in r["local_losses"])
          and math.isfinite(ev), f"14a {engine}: non-finite loss")
    check(counts["wire_quant_avg_dequant"] == rounds,
          f"14a {engine}: K3 launched {counts['wire_quant_avg_dequant']} "
          f"times in {rounds} synced rounds")
    del state, learner, split
    gc.collect()
    torch.cuda.empty_cache()
    return per_round, run


def _grads14(torch, fn, params, x):
    """Seconds (host clock, synchronised), peak GB over the live bytes
    before, and the gradients of ``fn(params, x)`` (a scalar) with
    respect to every leaf and ``x``."""
    from repro_torch.tree import leaves
    ts = [t.requires_grad_(True) for t in leaves(params)] + [
        x.requires_grad_(True)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    grads = torch.autograd.grad(fn(params, x), ts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 1e9, grads)


def _remat14(torch, tag, fn, params, x):
    """One layer forward and backward with the recomputation and without,
    each timed alone; their gradients held to each other afterwards
    (``REMAT_TOL14``, of each gradient's largest magnitude)."""
    runs = {}
    for remat in (True, False):
        with contextlib.nullcontext() if remat else remat_off():
            sec, peak, grads = _grads14(torch, fn, params, x)
        runs[remat] = {"seconds": sec, "peak_mem_GB": peak}, grads
        del grads
    err = 0.0
    for a, b in zip(runs[True][1], runs[False][1]):
        err = max(err, float((a - b).abs().max())
                  / max(float(b.abs().max()), 1e-30))
    check(err <= REMAT_TOL14, f"{tag}: remat on / off gradients differ by "
                              f"{err} of their scale")
    on, off = runs[True][0], runs[False][0]
    return {"remat": on, "no_remat": off, "grad_rel_diff": err,
            "peak_ratio": off["peak_mem_GB"] / max(on["peak_mem_GB"], 1e-9),
            "seconds_ratio": on["seconds"] / max(off["seconds"], 1e-9)}


def _phase14_xlstm(torch, dev, launches_out):
    """14(a): xlstm-1.3b at full width, depth LAYERS14: the python engine for
    PY_ROUNDS14 rounds, then the fused engine for FUSED_ROUNDS14 (one
    capture, then replays); then one mLSTM layer of that width with the
    recomputation and without."""
    from repro_torch.models import xlstm as xl
    cfg = xlstm14_cfg()
    py_rounds, py = _train14(torch, dev, cfg, "python", PY_ROUNDS14, {})
    fu_rounds, fu = _train14(torch, dev, cfg, "fused", FUSED_ROUNDS14,
                             launches_out)
    worst = 0.0
    for a, b in zip(py_rounds, fu_rounds):
        for u, v in [*zip(a["local_losses"], b["local_losses"]),
                     (a["rel_change"], b["rel_change"])]:
            if math.isinf(u):
                check(math.isinf(v), "14a: rel inf on one engine only")
                continue
            worst = max(worst, abs(u - v) / max(abs(u), 1e-12))
    check(worst <= TOL14["rtol"],
          f"14a: the engines' rounds differ by {worst} (rel)")
    for label, rounds in (("python", py_rounds), ("fused", fu_rounds)):
        losses = [sum(r["local_losses"]) / len(r["local_losses"])
                  for r in rounds]
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"14a {label}: the loss did not fall: {losses}")
    rnd = fu["graphs"]["round"]
    check((rnd["captures"], rnd["replays"]) == (1, FUSED_ROUNDS14 - 1),
          f"14a: round graph captured / replayed {rnd}")
    check(fu["window_sync_debug_modes"] == [2] * FUSED_ROUNDS14,
          f"14a: windows at sync debug modes {fu['window_sync_debug_modes']}")
    g = torch.Generator(device=dev).manual_seed(14)
    p = xl.mlstm_init(g, cfg, torch.float32)
    x = torch.randn((B14, S14, cfg.d_model), generator=g, device=dev)
    w = torch.randn((B14, S14, cfg.d_model), generator=g, device=dev)
    layer = _remat14(torch, "14a mLSTM layer",
                     lambda p_, x_: (xl.mlstm_apply(p_, x_, cfg) * w).sum(),
                     p, x)
    del p, x, w
    say("recurrent-training", part="a", arch=cfg.name,
        reduced=f"n_layers 48 -> {LAYERS14} ({LAYERS14 - 1} mLSTM + 1 "
                "sLSTM: the xLSTM[7:1] period cut from 8 layers for the "
                "script's clock; 4 before phase 17 was added); K 3 -> "
                f"{K14} for the script's clock (the python engine's rounds "
                "are host-bound and grow with K)",
        d_model=cfg.d_model, heads=cfg.n_heads,
        head_dim=int(cfg.xlstm_proj_factor * cfg.d_model) // cfg.n_heads,
        vocab=cfg.vocab_size, K=K14, batch=B14, seq_len=S14,
        steps_per_epoch=STEPS14, codec="fused int8", remat=REMAT14,
        remat_why="per-layer recomputation off: the capture's recording "
                  "and the eager rounds are host-bound and would grow by "
                  "about a forward; 16(b) takes xlstm's step with it on",
        python=py, fused=fu,
        engines_max_rel_diff=worst, mlstm_layer=layer)


def _phase14_jamba(torch, dev):
    """14(b): one jamba ``mamba:dense`` layer (norm, Mamba mixer through
    the plain scan, dense FFN) at full width, B14B x S14B, with the
    recomputation and without."""
    from repro_torch.models import transformer as tr
    cfg = jamba14_cfg()
    g = torch.Generator(device=dev).manual_seed(15)
    p = tr.layer_init(g, "mamba:dense", cfg, torch.float32)
    x = torch.randn((B14B, S14B, cfg.d_model), generator=g, device=dev)
    w = torch.randn((B14B, S14B, cfg.d_model), generator=g, device=dev)
    pos = torch.arange(S14B, device=dev).expand(B14B, S14B)

    def loss(p_, x_):
        y, _ = tr.layer_apply(p_, "mamba:dense", x_, cfg, pos)
        return (y * w).sum()
    layer = _remat14(torch, "14b mamba:dense layer", loss, p, x)
    say("recurrent-training", part="b", arch=cfg.name,
        reduced="n_layers 32 -> one mamba:dense layer (one 8-layer period "
                "is 53 GB of f32 params: K copies and gradients do not fit "
                "one card; the model trains at its smoke config in (c), "
                "(d))",
        d_model=cfg.d_model, d_inner=cfg.d_inner_ssm,
        ssm_state=cfg.ssm_state_dim, conv=cfg.ssm_conv_dim, d_ff=cfg.d_ff,
        batch=B14B, seq_len=S14B, layer=layer)
    del p, x, w


def _phase14_smoke(torch, dev):
    """14(c): the xlstm and jamba smoke configs at S14C, card against CPU
    from the same params: the loss and every gradient at TOL14, then
    one fused round each (K14C, exact codec; captured on the card) at
    TOL14 on its log and params."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import api
    from repro_torch.launch.train import build_data, epoch_batches_fn
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, tree_map
    out = {}
    for arch in ("xlstm-1.3b", "jamba-v0.1-52b"):
        cfg = get_smoke_config(arch)
        cpu = tr.init_params(0, cfg, torch.float32, device="cpu")
        rng = np.random.default_rng(0)
        b = {k: rng.integers(0, cfg.vocab_size, (2, S14C))
             for k in ("tokens", "labels")}
        data = build_data(cfg, K14C, 2, S14C, K14C * 2, seed=0)
        res, logs, rounds = {}, {}, {}
        for where in ("cpu", dev):
            ps = tree_map(lambda t: t.detach().to(where), cpu)
            flat = [t.requires_grad_(True) for t in leaves(ps)]
            tb = {k: torch.as_tensor(v, device=where) for k, v in b.items()}
            loss, _ = tr.loss_fn(ps, cfg, tb)
            res[str(where)] = [x.detach().cpu() for x in (
                loss, *torch.autograd.grad(loss, flat))]
            learner = _learner(torch, cfg, api.get_codec("exact"), K14C,
                               where, rounds=1, rule="fle")
            state = learner.init(cpu)
            t0 = time.perf_counter()
            state = learner.run_round(state, epoch_batches_fn(data, where,
                                                              1))
            rounds[str(where)] = time.perf_counter() - t0
            logs[str(where)] = (state["log"][-1], [
                t.detach().cpu() for t in leaves(state["params"])],
                learner._runner.graphs.captures)
            del learner, state
            gc.collect()
        err = 0.0
        for a, w in zip(res[str(dev)], res["cpu"]):
            err = max(err, _close(torch, a, w, TOL14,
                                  f"14c {arch}: card vs CPU gradient"))
        (cl, cp, _), (gl, gp, caps) = logs["cpu"], logs[str(dev)]
        perr = 0.0
        for a, w in zip(gp, cp):
            perr = max(perr, _close(torch, a, w, TOL14,
                                    f"14c {arch}: fused round params"))
        lerr = max(abs(u - v) / max(abs(u), 1e-12)
                   for u, v in zip(cl.local_losses, gl.local_losses))
        check(lerr <= TOL14["rtol"] and caps == 1,
              f"14c {arch}: fused round losses differ by {lerr}, "
              f"{caps} captures")
        out[arch] = {"grad_max_abs_err": err, "round_params_max_abs_err":
                     perr, "round_loss_rel_err": lerr,
                     "round_s": rounds, "captures": caps}
    say("recurrent-training", part="c", seq_len=S14C, K=K14C, tol=TOL14,
        archs=out)


def _phase14_cli(torch):
    """14(d): the train CLI on the card, 2 rounds of xlstm-1.3b and of
    jamba-v0.1-52b (their smoke configs), under the fused engine (the
    default) and the python engine."""
    import io
    from repro_torch.launch import train
    args = ["--device", "cuda", "--participants", "2", "--rounds", "2",
            "--t0", "1", "--n-examples", "32", "--batch-size", "4",
            "--seq-len", "16", "--steps-per-epoch", "2"]
    runs = {}
    for arch in ("xlstm-1.3b", "jamba-v0.1-52b"):
        for engine in ("fused", "python"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            flags = [] if engine == "fused" else ["--engine", engine]
            with contextlib.redirect_stdout(buf):
                rc = train.main(args + ["--arch", arch] + flags)
            lines = buf.getvalue().splitlines()
            rounds = [x for x in lines if x.startswith("round ")]
            runs[f"{arch} {engine}"] = {
                "rc": rc, "seconds": time.perf_counter() - t0,
                "lines": lines}
            check(rc == 0 and len(rounds) == 2
                  and f"engine={engine}" in lines[0]
                  and all("nan" not in x for x in rounds),
                  f"14d {arch} {engine}: rc {rc}, lines {lines}")
    say("recurrent-training", part="d", runs=runs)


def phase_recurrent_training(torch, dev, launches_out, mark):
    """Phase 14: training the recurrent families (see the docstring)."""
    _phase14_xlstm(torch, dev, launches_out)
    mark("14a")
    _phase14_jamba(torch, dev)
    mark("14b")
    _phase14_smoke(torch, dev)
    mark("14c")
    _phase14_cli(torch)
    mark("14d")


# ---------------------------------------------------------------------------
# phase 15: the pod path. POD_RANKS ranks share the one card over gloo (NCCL
# refuses two ranks on one device), started by spawn (this process has CUDA
# initialised). (a) runs internlm2-1.8b at full width and depth LAYERS15:
# each rank holds params, grads, the flat buffer, the dequantized payload
# and old_avg, about 5P f32 with P = 882,411,520 at depth 8 (17.6 GB and
# activations a rank; depth 12 would need about 80 GB for three).
POD_RANKS = 3
# depth 2, for the script's clock (8 took 103 s of phase 15 on a host
# where the whole script took 1,435 s; a round is wire-bound; 4 before
# phase 17 was added)
LAYERS15 = 2
B15, S15, STEPS15 = 8, 256, 2
POD15_TIMEOUT = 600
TOL15 = 1e-5          # pod vs simulation: only the K-term sum's order
LOG_TOL15 = {"rtol": 1e-5, "atol": 1e-6}


def cfg15():
    from repro_torch.configs import get_config
    return get_config("internlm2-1.8b").with_(
        n_layers=LAYERS15, segments=((("gqa:dense",), LAYERS15),))


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rows15(torch, data, i, dev, rows, steps):
    """Round i's one-epoch batch dict for participant rows ``rows``."""
    from repro_torch.core.engine import stage
    bx, by = data.epoch_batches(i, 0)
    return {"tokens": stage(bx[rows, :steps][None], device=dev),
            "labels": stage(by[rows, :steps][None], device=dev)}


def _pod15_rank(rank, world, out_dir, queue, dev_type, cfg_a, cfg_b):
    """One rank of phase 15, a spawned process: joins the gloo group on
    ``dev_type``, runs (a) on ``cfg_a`` and (b) on ``cfg_b``, and puts its
    report (or its traceback) on ``queue``."""
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch import mesh
        dev = mesh.init_process_mesh(rank, world, f"file://{out_dir}/rdv",
                                     "gloo", dev_type)
        try:
            pmesh = mesh.make_sim_mesh((world,), ("pod",), dev_type)
            report = {"a": _pod15_full(torch, rank, world, pmesh, dev,
                                       out_dir, cfg_a)}
            report["b"] = _pod15_forms(torch, rank, world, pmesh, dev,
                                       cfg_b)
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", report))
    except Exception:                  # the parent reports it and fails
        queue.put((rank, "error", traceback.format_exc()))


def _counts_since(before):
    from repro_torch.kernels import ops
    return {n: c - before[n] for n, c in ops.launch_counts().items()
            if c != before[n]}


def _round_record(torch, rf, dev, seconds, aux, counts):
    """One pod round's numbers on this rank (the device split from aux:
    tracing on, ``_pod15_full``)."""
    st = dict(rf.aggregate.pod.stats)
    split = {op: {part: st.get(f"{op}_{part}", 0.0)
                  for part in ("d2h_s", "wire_s", "h2d_s", "bytes",
                               "calls")}
             for op in ("all_reduce", "new_avg", "gather")}
    return {"seconds": seconds,
            "epochs_ms": aux["epochs_ms"],
            "finalize_ms": aux["finalize_ms"],
            "losses": aux["losses"].cpu().tolist(),
            "rel": float(aux["rel"]), "launches": counts,
            "collectives": split,
            "peak_mem_GB": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None)}


def _pod15_full(torch, rank, world, pmesh, dev, out_dir, cfg):
    """15(a) on one rank: fused int8, FullAverage, 2 rounds through
    ``make_fused_round_step(mesh=)``; rank 0 saves its params after each
    round for the parent's simulation."""
    from repro_torch import spans
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import flatbuf
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_data
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, leaves_with_path, tree_map
    data = build_data(cfg, world, B15, S15, world * B15 * STEPS15, seed=0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    init_sum = float(sum(t.sum(dtype=torch.float64) for t in leaves(params)))
    local = tree_map(lambda t: t[None], params)     # this rank's (1, ...) row
    ccfg = CoLearnConfig(n_participants=world, T0=1, eta0=0.05, max_rounds=2)
    rf = steps.make_fused_round_step(cfg, ccfg, mesh=pmesh, codec="fused")
    pod = rf.aggregate.pod
    rounds = []
    for i in range(2):
        batches = _rows15(torch, data, i, dev, slice(rank, rank + 1),
                          STEPS15)
        _sync(torch, dev)
        pod.reset_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        spans.enable()              # the round's epochs / finalize split
        try:
            local, _, aux = rf(local, (), batches, i)
        finally:
            spans.disable()
        _sync(torch, dev)
        rec = _round_record(torch, rf, dev, time.perf_counter() - t0, aux,
                            _counts_since(before))
        # new_avg is rank 0's row, broadcast: equal rows on every rank
        rec["equals_rank0"] = all(torch.equal(t[0], a) for t, a in zip(
            leaves(local), leaves(aux["new_avg"])))
        rounds.append(rec)
        if rank == 0:
            torch.save({p: t[0].cpu() for p, t in leaves_with_path(local)},
                       f"{out_dir}/a_round{i}.pt")
    g = rf.graphs.functions[0]
    return {"rounds": rounds, "init_sum": init_sum,
            "params": tr.count_params(params),
            "wire_bytes": flatbuf.wire_bytes(flatbuf.make_layout(local)),
            "epochs_graph": {"captures": g.captures, "replays": g.replays}}


def _gather15(torch, pod, tree):
    """Every rank's ``(1, ...)`` rows of ``tree`` -> the ``(K, ...)``
    stack, one broadcast from each rank (checks only)."""
    from repro_torch.tree import leaves, unflatten_like
    rows = []
    for j in range(pod.size):
        buf = [t.clone() if j == pod.index else torch.empty_like(t)
               for t in leaves(tree)]
        pod.broadcast_(buf, j)
        rows.append(buf)
    return unflatten_like(tree, [torch.cat(ls) for ls in zip(*rows)])


def _forms15(api):
    """15(b)'s forms: name -> (codec, aggregator, step keywords)."""
    i8 = api.FlatFusedInt8()
    return {
        "int4+ef": (api.FlatFusedIntN(bits=4, error_feedback=True),
                    api.FullAverage(), {}),
        "leafwise": (api.LeafwiseInt8(), api.FullAverage(), {}),
        "weights 3:2:1 masked": (i8, api.FullAverage(weights=(3., 2., 1.)),
                                 {"masked": True}),
        "partial m=2": (i8, api.PartialParticipation(m=2, seed=0), {}),
        "live, rank 1 dead in round 1": (i8, api.FullAverage(),
                                         {"live": True}),
        "ring": (i8, api.RingGossip(), {}),
        "graph[complete]": (i8, api.GraphGossip("complete"), {}),
        "d2[ring]": (i8, api.D2Gossip("ring"), {}),
        "dense: graph[exponential]": (i8, api.GraphGossip("exponential"),
                                      {}),
    }


MASK15 = ((True, True, True), (True, True, False), (True, False, False))


def _pod15_forms(torch, rank, world, pmesh, dev, cfg):
    """15(b) on one rank: each form for 2 rounds on the pod; after each
    round the rows are gathered and rank 0 runs the same round on the
    simulation path (``mesh=None``, the K rows stacked on the card) from
    the pod's rows before it, and compares."""
    import numpy as np
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core import api
    from repro_torch.core.collectives import PodAxis
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_data
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, tree_map
    checks = PodAxis(pmesh)
    K, n_batches = world, 3
    data = build_data(cfg, K, 4, 32, K * 4 * n_batches, seed=1)
    g = torch.Generator(device=dev).manual_seed(15)
    base = tr.init_params(1, cfg, torch.float32, device=dev)
    start = tree_map(lambda t: t[None] + 0.02 * torch.randn(
        (K, *t.shape), generator=g, device=dev), base)
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, max_rounds=2)
    own = slice(rank, rank + 1)
    out = {}
    for name, (codec, agg, kw) in _forms15(api).items():
        pod_rf = steps.make_fused_round_step(cfg, ccfg, mesh=pmesh,
                                             codec=codec, aggregator=agg,
                                             **kw)
        sim_rf = (steps.make_fused_round_step(cfg, ccfg, codec=codec,
                                              aggregator=agg, device=dev,
                                              **kw) if rank == 0 else None)
        stateful = codec.stateful or agg.stateful
        local = tree_map(lambda t: t[own].clone(), start)
        state = agg.init_round_state(codec, local)
        prev = (tree_map(torch.clone, start),
                agg.init_round_state(codec, start))
        rec = {"rounds": [], "dense_fallback": pod_rf.aggregate.dense_fallback}
        for i in range(2):
            live_np = (np.array([1, 0, 1] if i == 1 else [1, 1, 1],
                                np.float32) if kw.get("live") else None)
            W = agg.mixing_matrix(i, K, live=None if live_np is None
                                  else live_np > 0)
            Wt = torch.as_tensor(np.array(W), device=dev)
            live_t = (None if live_np is None
                      else torch.as_tensor(live_np, device=dev))
            mask = torch.as_tensor(np.array(MASK15), device=dev)

            def args(rows, st):
                a = ([st] if stateful else []) + [
                    _rows15(torch, data, i, dev, rows, n_batches)]
                if kw.get("masked"):
                    a.append(mask[rows])
                if kw.get("live"):
                    a.append(live_t)
                a.append(i)
                if agg.uses_weights or kw.get("live"):
                    a.append(Wt)
                return a
            before_row = [t.clone() for t in leaves(local)]
            pod_rf.aggregate.pod.reset_stats()
            cb = ops.launch_counts()
            local, _, aux = pod_rf(local, (), *args(own, state))
            if stateful:
                state = aux["residual"]
            counts = _counts_since(cb)
            st = dict(pod_rf.aggregate.pod.stats)
            r = {"launches": counts, "p2p_legs": st.get("p2p_legs", 0.0),
                 "moved_bytes": sum(v for k_, v in st.items()
                                    if k_.endswith("_bytes")),
                 "comm_bytes": agg.comm_bytes(
                     codec, tree_map(lambda t: t.expand(K, *t.shape[1:]),
                                     local), i,
                     None if live_np is None else live_np > 0),
                 "rel": float(aux["rel"]), "losses": aux["losses"].tolist()}
            if kw.get("live") and i == 1 and rank == 1:
                r["dead_row_unchanged"] = all(
                    torch.equal(a, b) for a, b in zip(before_row,
                                                      leaves(local)))
            if codec.stateful:
                res = state["res"] if agg.stateful else state
                r["residual_on_rank"] = [str(res.device), list(res.shape),
                                         float(res.abs().max())]
            rows = _gather15(torch, checks, local)
            srows = (_gather15(torch, checks, state) if stateful else None)
            if rank == 0:
                params, sstate = prev
                params, _, saux = sim_rf(params, (), *args(slice(None),
                                                           sstate))
                r["sim"] = {
                    "max_param_diff": max(float((a - b).abs().max())
                                          for a, b in zip(leaves(params),
                                                          leaves(rows))),
                    "max_loss_diff": float((saux["losses"]
                                            - aux["losses"]).abs().max()),
                    "rel": float(saux["rel"]),
                    "comm_bytes": agg.comm_bytes(
                        codec, params, i,
                        None if live_np is None else live_np > 0)}
                if stateful:
                    r["sim"]["max_state_diff"] = max(
                        float((a - b).abs().max()) for a, b in zip(
                            leaves(saux["residual"]), leaves(srows)))
                prev = (rows, srows)
            rec["rounds"].append(r)
        out[name] = rec
    return out


def phase_pod(torch, dev, launches_out, mark):
    """Phase 15: the pod path (see the docstring)."""
    import multiprocessing as mp
    import queue as queue_mod

    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_data
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, leaves_with_path, tree_map
    from repro_torch.models import xlstm
    out_dir = ROOT / "build" / "pod15"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    # the ranks need the card: this process keeps no graph pool or cache
    xlstm.release_slstm_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = (torch.cuda.memory_allocated() / 1e9,
                 torch.cuda.memory_reserved() / 1e9)
    cfg = cfg15()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_pod15_rank, daemon=True, args=(
        k, POD_RANKS, str(out_dir), q, dev.type, cfg,
        get_smoke_config("internlm2-1.8b"))) for k in range(POD_RANKS)]
    t0 = time.time()
    for p in procs:
        p.start()
    reports, errors = {}, []
    try:
        while len(reports) < POD_RANKS and not errors:
            try:
                k, status, payload = q.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.time() - t0 > POD15_TIMEOUT:
                    errors.append(f"ranks exited {dead} or timed out")
                continue
            if status == "ok":
                reports[k] = payload
            else:
                errors.append(f"rank {k}: {payload}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors, "15: " + (errors[0][-4000:] if errors else ""))
    ranks_s = time.time() - t0
    mark("15 ranks")

    # (a): each rank's rounds, then the simulation path on the card
    a = [reports[k]["a"] for k in range(POD_RANKS)]
    for k, rep in enumerate(a):
        for i, r in enumerate(rep["rounds"]):
            check(r["equals_rank0"], f"15a: rank {k} round {i} differs "
                  "from rank 0's row")
            check(r["launches"].get("wire_quantize") == 1
                  and r["launches"].get("wire_dequantize") == 1
                  and len(r["launches"]) == 2,
                  f"15a: rank {k} round {i} launched {r['launches']}")
        check(rep["init_sum"] == a[0]["init_sum"],
              f"15a: rank {k}'s init differs from rank 0's")
        losses = [float(np.mean(r["losses"])) for r in rep["rounds"]]
        check(losses[1] < losses[0], f"15a: the loss did not fall {losses}")
    torch.cuda.reset_peak_memory_stats()
    data = build_data(cfg, POD_RANKS, B15, S15, POD_RANKS * B15 * STEPS15,
                      seed=0)
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    check(float(sum(t.sum(dtype=torch.float64) for t in leaves(params)))
          == a[0]["init_sum"], "15a: the parent's init differs")
    stacked = tree_map(lambda t: t[None].expand(POD_RANKS, *t.shape)
                       .contiguous(), params)
    del params
    ccfg = CoLearnConfig(n_participants=POD_RANKS, T0=1, eta0=0.05,
                         max_rounds=2)
    rf = steps.make_fused_round_step(cfg, ccfg, codec="fused", device=dev)
    sim = []
    for i in range(2):
        if i:      # the round starts from the pod's rows after round i-1
            saved = torch.load(out_dir / f"a_round{i - 1}.pt", mmap=True)
            for path, t in leaves_with_path(stacked):
                t.copy_(saved[path][None].expand_as(t))
            del saved
        t1 = time.perf_counter()
        stacked, _, aux = rf(stacked, (), _rows15(
            torch, data, i, dev, slice(None), STEPS15), i)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        pod_row = torch.load(out_dir / f"a_round{i}.pt", mmap=True)
        diff = max(float((t[0] - pod_row[p].to(dev)).abs().max())
                   for p, t in leaves_with_path(stacked))
        del pod_row
        losses = aux["losses"].cpu().numpy()
        pod_losses = np.array(a[0]["rounds"][i]["losses"])
        sim.append({"seconds": sec, "max_param_diff": diff,
                    "losses": losses.tolist(), "rel": float(aux["rel"]),
                    "max_loss_diff": float(np.abs(losses - pod_losses)
                                           .max())})
        check(diff <= TOL15, f"15a round {i}: pod vs simulation params "
              f"differ by {diff}")
        np.testing.assert_allclose(pod_losses, losses, **LOG_TOL15)
        np.testing.assert_allclose(a[0]["rounds"][i]["rel"],
                                   float(aux["rel"]), **LOG_TOL15)
    sim_peak = torch.cuda.max_memory_allocated() / 1e9
    del stacked, rf, aux
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    for rep in a:
        for r in rep["rounds"]:
            for n, c in r["launches"].items():
                launches_out[n] = launches_out.get(n, 0) + c
    say("pod", part="a", arch=cfg.name, ranks=POD_RANKS, backend="gloo",
        reduced=f"n_layers 24 -> {LAYERS15} (the script's clock, 4 before "
                "phase 17 was added; each "
                "rank holds about five f32 model copies: params, grads, "
                "the flat buffer, the dequantized payload, old_avg, so 8 "
                "is the most three ranks fit)",
        params_per_rank=a[0]["params"], d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, batch=B15, seq_len=S15,
        steps_per_epoch=STEPS15, codec="fused int8",
        wire_bytes=a[0]["wire_bytes"], ranks_seconds=ranks_s,
        parent_allocated_reserved_GB_while_ranks_ran=parent_gb,
        per_rank=a, simulation=sim, simulation_peak_mem_GB=sim_peak)
    mark("15a")

    # (b): the other forms, as rank 0 compared them on the card
    b = [reports[k]["b"] for k in range(POD_RANKS)]
    for name, rec in b[0].items():
        dense = name.startswith("dense")
        for k in range(POD_RANKS):
            check(b[k][name]["dense_fallback"] == dense,
                  f"15b {name}: rank {k} dense_fallback "
                  f"{b[k][name]['dense_fallback']}")
        for i, r in enumerate(rec["rounds"]):
            s = r["sim"]
            check(s["max_param_diff"] <= TOL15
                  and s.get("max_state_diff", 0.0) <= TOL15,
                  f"15b {name} round {i}: pod vs simulation {s}")
            np.testing.assert_allclose(r["rel"], s["rel"], **LOG_TOL15)
            check(s["max_loss_diff"] <= LOG_TOL15["atol"] + LOG_TOL15[
                "rtol"] * max(abs(x) for x in np.ravel(r["losses"])),
                f"15b {name} round {i}: losses differ {s}")
            check(r["comm_bytes"] == s["comm_bytes"],
                  f"15b {name} round {i}: comm bytes {r['comm_bytes']} vs "
                  f"{s['comm_bytes']}")
            for k in range(POD_RANKS):
                rk = b[k][name]["rounds"][i]
                if name == "graph[complete]":
                    check(rk["p2p_legs"] == 2, f"15b {name}: legs {rk}")
                if "residual_on_rank" in rk:
                    dv, shape, mx = rk["residual_on_rank"]
                    check(dv.startswith(dev.type) and shape[0] == 1
                          and mx > 0, f"15b {name}: residual {rk}")
                for n, c in rk["launches"].items():
                    launches_out[n] = launches_out.get(n, 0) + c
        if name.startswith("live"):
            check(b[1][name]["rounds"][1].get("dead_row_unchanged"),
                  "15b live: rank 1's row moved while it was dead")
    say("pod", part="b", config="internlm2-1.8b smoke", ranks=POD_RANKS,
        forms={name: {"rank0": b[0][name], "other_ranks": [
            [{f: r.get(f) for f in ("launches", "p2p_legs", "moved_bytes",
                                    "residual_on_rank",
                                    "dead_row_unchanged")}
             for r in b[k][name]["rounds"]] for k in range(1, POD_RANKS)]}
            for name in b[0]})
    mark("15b")


# ---------------------------------------------------------------------------
# phase 16: per-layer recomputation (``remat``, the reference's default) on
# the training path, and the guards of ``repro_torch.analysis`` on the card.
# (a) internlm2-1.8b at full width and phase 5's depth (LAYERS), K16
# participants, fused int8, T 1, batch 8 x 256, 2 steps an epoch: one
# capture round and ROUNDS16 - 1 replays with remat on, then with it off,
# from the same params and batches; (b) xlstm-1.3b at phase 14's depth,
# batch and length, one eager step of one participant both ways; (c) the
# replays of (a) under guards.no_transfer and guards.no_retrace(limit=1),
# with two negative controls.
K16, ROUNDS16 = 3, 3
B16, S16, STEPS16 = 8, 256, 2
REMAT_TOL16 = 1e-5    # the engine's: the card does not promise bit-equality
GRAD_TOL16 = 2e-4     # K7's f32 mLSTM limit (ROADMAP queue 3)


def _step_peak16(torch, cfg, params, batch, remat):
    """One eager step of one participant (loss and every gradient):
    seconds (host clock, synchronised), peak GB over the live bytes
    before, and the gradients."""
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves, unflatten_like
    ps = [t.detach().requires_grad_(True) for t in leaves(params)]
    p = unflatten_like(params, ps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, _ = tr.loss_fn(p, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, ps)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "peak_GB": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "loss": float(loss.detach())}, grads


def _run16(torch, dev, cfg, remat, data, launches_out, models, compare):
    """16(a): ROUNDS16 rounds (one capture, then replays) of the fused
    engine with ``remat``; each replay under ``guards.no_transfer`` and
    ``guards.no_retrace(limit=1)``. After each round the shared model is
    copied into ``models`` (one model a round, allocated before either
    run) or, with ``compare``, held against it. Returns the run's record,
    the largest distance from ``models`` after each round (``compare``)
    and the guarded round graph with the last replay's arguments."""
    from repro_torch.analysis import guards
    from repro_torch.configs.base import InputShape
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.launch import analytic
    from repro_torch.launch.train import epoch_batches_fn
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    learner = _learner(torch, cfg, api.get_codec("fused"), K16, dev,
                       rounds=ROUNDS16, rule="fle", remat=remat)
    held = {}

    def guarded(graph):
        held["guard"] = guards.no_retrace(graph, limit=1,
                                          what="16a round graph")

        def call(*a):
            held["args"], held["graph"] = a, graph
            with guards.no_transfer(dev):
                held.setdefault("modes", []).append(
                    torch.cuda.get_sync_debug_mode())
                return held["guard"](*a)
        return call
    split = _round_events(torch, learner)
    learner._runner._round = guarded(learner._runner._round)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # live before the run: ``models``
    base = torch.cuda.memory_allocated()
    state = learner.init(tr.init_params(0, cfg, torch.float32, device=dev))
    batches = epoch_batches_fn(data, dev, STEPS16)
    torch.cuda.synchronize()
    flops = analytic.model_flops(
        cfg, InputShape("16a", S16, K16 * STEPS16 * B16, "train"), "train")
    ops.reset_launch_counts()
    per_round, diffs, stats = [], [], []
    with graph_stats(torch, stats):
        for _ in range(ROUNDS16):
            t0 = time.perf_counter()
            state = learner.run_round(state, batches)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            epochs_ms, fin_ms = split()
            log = state["log"][-1]
            per_round.append({
                "round": log.round, "T": log.T, "seconds": sec,
                "model_TFLOP_per_s": flops * log.T / sec / 1e12,
                "device_ms": {"epochs": epochs_ms, "finalize": fin_ms},
                "local_loss": float(sum(log.local_losses)
                                    / len(log.local_losses)),
                "rel_change": log.rel_change,
                "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
                "reserved_GB": torch.cuda.memory_reserved() / 1e9})
            row = models[len(per_round) - 1]
            if compare:
                diffs.append(max(float((t[0] - a).abs().max()) for t, a in
                                 zip(leaves(state["params"]), row)))
            else:
                for t, a in zip(leaves(state["params"]), row):
                    a.copy_(t[0])
    counts = ops.launch_counts()
    rnd = held["graph"]
    run = {"remat": remat, "rounds": per_round,
           "capture_round_s": per_round[0]["seconds"],
           "replayed_round_s": [r["seconds"] for r in per_round[1:]],
           "capture": stats, "nodes": [x["nodes"] for x in stats],
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_GB": torch.cuda.max_memory_reserved() / 1e9,
           "live_before_GB": base / 1e9,
           "peak_over_live_before_GB":
               (torch.cuda.max_memory_allocated() - base) / 1e9,
           "model_flops_per_round": flops,
           "graphs": {f.name: {"captures": f.captures, "replays": f.replays}
                      for f in learner._runner.graphs.functions},
           "window_sync_debug_modes": held["modes"],
           "launches": {k: v for k, v in counts.items() if v}}
    check(all(math.isfinite(r["local_loss"]) for r in per_round),
          f"16a remat={remat}: non-finite loss")
    check(counts["wire_quant_avg_dequant"] == ROUNDS16,
          f"16a remat={remat}: K3 launched "
          f"{counts['wire_quant_avg_dequant']} times in {ROUNDS16} rounds")
    check((rnd.captures, rnd.replays) == (1, ROUNDS16 - 1)
          and guards.compile_count(rnd) == 1,
          f"16a remat={remat}: round graph captured / replayed "
          f"{rnd.captures} / {rnd.replays}")
    check(held["modes"] == [2] * ROUNDS16,
          f"16a remat={remat}: replays at sync modes {held['modes']}")
    if remat:
        for name, n in counts.items():
            launches_out[name] = launches_out.get(name, 0) + n
    step = None
    if remat:
        step = {"guard": held["guard"], "args": held["args"]}
    del state, learner, split, held, rnd
    gc.collect()
    torch.cuda.empty_cache()
    return run, diffs, step


def _negative16(torch, dev, step):
    """16(c)'s negative controls: a ``.item()`` inside ``no_transfer``
    raises (and the mode comes back), and the guarded round graph given
    a second argument layout raises before capturing."""
    from repro_torch.analysis import guards
    out = {}
    x = torch.ones(4, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    try:
        with guards.no_transfer(dev):
            x.sum().item()
        out["item"] = None
    except RuntimeError as e:
        out["item"] = str(e).splitlines()[0]
    check(out["item"] is not None, "16c: .item() inside no_transfer did "
                                   "not raise")
    check(torch.cuda.get_sync_debug_mode() == before,
          "16c: no_transfer did not restore the sync debug mode")
    args = list(step["args"])
    # the same round on the first of its batches: the staged (T, K,
    # n_batches, B, S) tokens and labels in another layout
    i = next(j for j, a in enumerate(args)
             if isinstance(a, (list, tuple)) and a
             and all(isinstance(t, torch.Tensor) and t.ndim == 5 for t in a))
    args[i] = type(args[i])(t[:, :, :1] for t in args[i])
    guard = step["guard"]
    n = guard.compile_count()
    try:
        guard(*args)
        out["layout"] = None
    except guards.RetraceError as e:
        out["layout"] = str(e)
    check(out["layout"] is not None and guard.compile_count() == n == 1,
          f"16c: a second layout past the limit did not raise before "
          f"capturing ({out['layout']}, {guard.compile_count()} captures)")
    return out


def _phase16_xlstm(torch, dev):
    """16(b): xlstm-1.3b at phase 14's depth (LAYERS14), batch and length:
    one eager step of one participant with per-layer recomputation and
    without (the recurrences' ``chunked_scan`` checkpoints nested inside
    the layers' with it)."""
    from repro_torch.models import transformer as tr
    cfg = xlstm14_cfg()
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(16)
    batch = {k: torch.randint(0, cfg.vocab_size, (B14, S14), generator=g,
                              device=dev) for k in ("tokens", "labels")}
    runs, grads = {}, {}
    # warm-up (cuBLAS, the autograd engine) on a 16-step slice: the
    # recurrences then run plain loops
    _step_peak16(torch, cfg, params, {k: v[:, :16] for k, v in
                                      batch.items()}, False)
    for remat in (True, False):
        runs[remat], grads[remat] = _step_peak16(torch, cfg, params, batch,
                                                 remat)
    err = max(float((a - b).abs().max())
              for a, b in zip(grads[True], grads[False]))
    scale = max(float(b.abs().max()) for b in grads[False])
    check(err <= GRAD_TOL16, f"16b: remat on / off gradients differ by "
                             f"{err} > {GRAD_TOL16}")
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name,
            "reduced": f"n_layers 48 -> {LAYERS14} (phase 14's depth)",
            "batch": B14, "seq_len": S14, "remat": runs[True],
            "no_remat": runs[False], "grad_max_abs_diff": err,
            "grad_scale": scale, "tol": GRAD_TOL16,
            "peak_ratio": runs[False]["peak_GB"]
            / max(runs[True]["peak_GB"], 1e-9),
            "seconds_ratio": runs[True]["seconds"]
            / max(runs[False]["seconds"], 1e-9)}


def phase_remat(torch, dev, launches_out, smi, mark):
    """Phase 16: per-layer recomputation and the guards (see the
    docstring)."""
    from repro_torch.launch.train import build_data
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves
    cfg = full_cfg()
    data = build_data(cfg, K16, B16, S16, K16 * B16 * STEPS16, seed=0)
    g = torch.Generator(device=dev).manual_seed(17)
    one = {k: torch.randint(0, cfg.vocab_size, (B16, S16), generator=g,
                            device=dev) for k in ("tokens", "labels")}
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    steps = {}
    _step_peak16(torch, cfg, params, one, False)              # warm-up
    for remat in (True, False):
        steps[remat], grads = _step_peak16(torch, cfg, params, one, remat)
        del grads
    # the first run's shared model after each round stays on the card
    # (ROUNDS16 x 5.54 GB, allocated here: both runs start beside it)
    held = [[torch.empty_like(t) for t in leaves(params)]
            for _ in range(ROUNDS16)]
    del params
    runs = {}
    runs[True], _, step = _run16(torch, dev, cfg, True, data, launches_out,
                                 held, False)
    neg = _negative16(torch, dev, step)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    runs[False], diffs, _ = _run16(torch, dev, cfg, False, data, {}, held,
                                   True)
    del held
    gc.collect()
    torch.cuda.empty_cache()
    check(all(d <= REMAT_TOL16 for d in diffs),
          f"16a: remat on / off params differ by {diffs} after the rounds")
    mark("16a, 16c")
    xl = _phase16_xlstm(torch, dev)
    mark("16b")
    on, off = runs[True], runs[False]
    say("remat", part="a", card=smi, arch=cfg.name,
        reduced=f"n_layers 24 -> {LAYERS} (phase 5's depth)", K=K16,
        batch=B16, seq_len=S16, steps_per_epoch=STEPS16, codec="fused int8",
        remat=on, no_remat=off, params_max_abs_diff_per_round=diffs,
        tol=REMAT_TOL16, one_step={"remat": steps[True],
                                   "no_remat": steps[False]},
        replayed_s_ratio=statistics.median(on["replayed_round_s"])
        / statistics.median(off["replayed_round_s"]),
        peak_GB_saved=(off["peak_over_live_before_GB"]
                       - on["peak_over_live_before_GB"]),
        step_peak_GB_saved=steps[False]["peak_GB"] - steps[True]["peak_GB"])
    say("remat", part="b", card=smi, **xl)
    say("remat", part="c", card=smi,
        replays_under=["guards.no_transfer", "guards.no_retrace(limit=1)"],
        window_sync_debug_modes={"remat": on["window_sync_debug_modes"],
                                 "no_remat": off["window_sync_debug_modes"]},
        negative_controls=neg)


# ---------------------------------------------------------------------------
# phase 17: the intra-pod mesh. IP_RANKS ranks share the card over gloo,
# spawned as phase 15's. First a probe: two ranks try the collectives
# DTensor calls on CUDA tensors, each result kept. (a) mesh (data 2,
# model 2): internlm2-1.8b at full width, LAYERS17 layers, one train step
# at B17 x S17 (params over data and model by param_specs, the batch over
# data), a prefill and DEC17 decode steps on cache_specs' placements,
# held against the same steps run unsharded on the card (rank 0, after
# the mesh steps) at TOL17. (b) mesh (pod 2, data 1, model 2) over the
# same ranks: one fused round, K = 2, T 1, exact and 8-bit flat (K1 and
# K2 on the pod's gathered row), against the simulation path at TOL15,
# both pods' shared rows equal bit for bit. Each rank records its peak,
# every collective's calls, bytes and seconds, and the phase's seconds.
IP_RANKS = 4
LAYERS17 = 2
# 2 decode steps (8 before: 16.1 s of phase 17's 88.3 where the whole
# script took 808.4 s, NVIDIA H100 80GB HBM3, 700 W; each step is host-
# bound on the staged collectives)
B17, S17, DEC17 = 8, 256, 2
TOL17 = {"rtol": 1e-5, "atol": 1e-5}
IP17_TIMEOUT = 900
PROBE17 = ("all_gather_into_tensor", "reduce_scatter_tensor",
           "all_to_all_single", "all_reduce")


def cfg17():
    from repro_torch.configs import get_config
    return get_config("internlm2-1.8b").with_(
        n_layers=LAYERS17, segments=((("gqa:dense",), LAYERS17),))


def _probe17(torch, dist, rank, dev):
    """Each collective DTensor calls, on CUDA tensors over a gloo pair:
    whether it ran and gave the right values, or its error."""
    pair = dist.new_group([0, 1], backend="gloo")
    out = {}
    if rank >= 2:
        return out
    for name in PROBE17:
        xs = [torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
              for r in range(2)]
        x = xs[rank]
        try:
            if name == "all_gather_into_tensor":
                y = torch.empty(8, device=dev)
                dist.all_gather_into_tensor(y, x, group=pair)
                want = torch.cat(xs)
            elif name == "reduce_scatter_tensor":
                y = torch.empty(2, device=dev)
                dist.reduce_scatter_tensor(y, x, group=pair)
                want = (xs[0] + xs[1])[2 * rank:2 * rank + 2]
            elif name == "all_to_all_single":
                y = torch.empty(4, device=dev)
                dist.all_to_all_single(y, x, group=pair)
                want = torch.cat([xs[0][2 * rank:2 * rank + 2],
                                  xs[1][2 * rank:2 * rank + 2]])
            else:
                y = x.clone()
                dist.all_reduce(y, group=pair)
                want = xs[0] + xs[1]
            torch.cuda.synchronize(dev)
            out[name] = {"ran": True, "right": bool(torch.equal(y, want))}
        except Exception as e:                # kept: the record says why
            out[name] = {"ran": False,
                         "error": f"{type(e).__name__}: {e}"[:400]}
    return out


def _comm_stats():
    """A dispatch mode that counts the calls, bytes and seconds of every
    DTensor collective a rank runs (the functional collectives on its
    local tensors; ``wait_tensor`` synchronises the device, so a
    collective's seconds run to its end). ``.stats`` holds them."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.stats = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func._overloadpacket.__name__
            if func.namespace != "_c10d_functional" or \
                    name == "_wrap_tensor_autograd":
                return func(*args, **kwargs)
            t0 = time.perf_counter()
            out = func(*args, **kwargs)
            if name == "wait_tensor":
                torch.cuda.synchronize()
            st = self.stats.setdefault(name, {"calls": 0, "bytes": 0,
                                              "seconds": 0.0})
            st["calls"] += 1
            if isinstance(args[0], torch.Tensor):
                st["bytes"] += args[0].numel() * args[0].element_size()
            st["seconds"] += time.perf_counter() - t0
            return out
    return Mode()


def _gap17(torch, got, want):
    """Over a tree pair: ``rel``, the largest |got - want| / (atol + rtol
    |want|) (<= 1 is within TOL17), and the largest |got - want| and
    |want| beside it."""
    from repro_torch.tree import leaves
    gap = {"rel": 0.0, "max_abs_err": 0.0, "max_abs_ref": 0.0}
    for a, b in zip(leaves(got), leaves(want)):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        gap["rel"] = max(gap["rel"], float((d / (
            TOL17["atol"] + TOL17["rtol"] * b.abs())).max()))
        gap["max_abs_err"] = max(gap["max_abs_err"], float(d.max()))
        gap["max_abs_ref"] = max(gap["max_abs_ref"], float(b.abs().max()))
    return gap


def _ip17_a(torch, rank, dev, mesh):
    """17(a) on one rank: the mesh steps; rank 0 then runs them
    unsharded and reports the worst relative gap."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import specs as sp
    from repro_torch.tree import tree_map
    cfg = cfg17()
    g = torch.Generator().manual_seed(17)
    tok = torch.randint(0, cfg.vocab_size, (B17, S17), generator=g)
    lab = torch.randint(0, cfg.vocab_size, (B17, S17), generator=g)
    dec = torch.randint(0, cfg.vocab_size, (B17, DEC17), generator=g)
    batch = {"tokens": tok.to(dev), "labels": lab.to(dev)}
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    comm = _comm_stats()
    times = {}
    dparams = sp.distribute(params, sp.param_specs(params, cfg, mesh), mesh)
    dbatch = sp.distribute(batch, sp.batch_specs(cfg, mesh, "train"), mesh)
    if rank:
        del params
    out = {}
    with comm:
        t0 = time.perf_counter()
        new, loss = steps.make_train_step(cfg, lr=0.01, mesh=mesh)(
            dparams, dbatch)
        torch.cuda.synchronize(dev)
        times["train_s"] = time.perf_counter() - t0
        new_full = sp.gather(new)
        del new
        t0 = time.perf_counter()
        pre = sp.gather(steps.make_prefill_step(cfg)(dparams, dbatch))
        torch.cuda.synchronize(dev)
        times["prefill_s"] = time.perf_counter() - t0
        cache = tr.init_cache(cfg, B17, S17, torch.float32, device=dev)
        dcache = sp.distribute(cache, sp.cache_specs(cache, mesh, B17), mesh)
        del cache
        serve = steps.make_serve_step(cfg)
        logits = []
        t0 = time.perf_counter()
        for i in range(DEC17):
            dtok = sp.distribute({"tokens": dec[:, i:i + 1].to(dev)},
                                 sp.batch_specs(cfg, mesh, "decode"),
                                 mesh)["tokens"]
            lg, dcache = serve(dparams, dcache, dtok,
                               torch.tensor(i, device=dev))
            logits.append(sp.gather(lg))
        torch.cuda.synchronize(dev)
        times["decode_s"] = time.perf_counter() - t0
    out.update(times)
    out["collectives"] = comm.stats
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["loss"] = float(loss)
    del dparams, dcache
    dist.barrier()
    if rank == 0:
        # the same steps unsharded on the card, from the same params
        t0 = time.perf_counter()
        want, wloss = steps.make_train_step(cfg, lr=0.01)(params, batch)
        out["gap_train_params"] = _gap17(torch, new_full, want)
        out["gap_train_loss"] = abs(float(loss) - float(wloss)) / (
            TOL17["atol"] + TOL17["rtol"] * abs(float(wloss)))
        del want, new_full
        wpre = steps.make_prefill_step(cfg)(params, batch)
        out["gap_prefill"] = _gap17(torch, [pre], [wpre])
        # both f32 prefills against an f64 one: how far each is from the
        # exact value
        p64 = tree_map(lambda t: t.double(), params)
        w64 = steps.make_prefill_step(cfg)(p64, batch)
        del p64
        out["prefill_err_vs_f64"] = {
            "mesh": float((pre.double() - w64).abs().max()),
            "unsharded": float((wpre.double() - w64).abs().max())}
        del w64
        cache = tr.init_cache(cfg, B17, S17, torch.float32, device=dev)
        serve = steps.make_serve_step(cfg)
        gaps = []
        for i in range(DEC17):
            lg, cache = serve(params, cache, dec[:, i:i + 1].to(dev),
                              torch.tensor(i, device=dev))
            gaps.append(_gap17(torch, [logits[i]], [lg]))
        out["gap_decode"] = gaps
        out["unsharded_s"] = time.perf_counter() - t0
        del params, cache
    dist.barrier()
    return out


def _ip17_b(torch, rank, dev, mesh):
    """17(b) on one rank: one fused round on the (pod 2, data 1, model 2)
    mesh, exact and flat int8; rank 0 then runs the simulation path on
    the stacked rows and reports the gaps."""
    import torch.distributed as dist
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import specs as sp
    from repro_torch.tree import leaves, tree_map
    cfg = cfg17()
    K = 2
    g = torch.Generator().manual_seed(171)
    tok = torch.randint(0, cfg.vocab_size, (1, K, 1, B17, S17), generator=g)
    lab = torch.randint(0, cfg.vocab_size, (1, K, 1, B17, S17), generator=g)
    rb = {"tokens": tok.to(dev), "labels": lab.to(dev)}
    params = tr.init_params(0, cfg, torch.float32, device=dev)
    stacked = tree_map(lambda t: torch.stack([t, t * (1 + 1e-3)]), params)
    del params
    pspecs = sp.param_specs(stacked, cfg, mesh, participant=True)
    rspec = (None, "pod", None, "data", None)
    batches = sp.distribute(rb, {"tokens": rspec, "labels": rspec}, mesh)
    ccfg = CoLearnConfig(n_participants=K, T0=1, eta0=0.05, max_rounds=1)
    out = {}
    for codec in ("exact", "fused"):
        rf = steps.make_fused_round_step(cfg, ccfg, mesh=mesh, codec=codec,
                                         param_specs=pspecs)
        rows = sp.distribute(stacked, pspecs, mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        before = ops.launch_counts()
        comm = _comm_stats()
        t0 = time.perf_counter()
        with comm:
            rows, _, aux = rf(rows, (), batches, 0)
        torch.cuda.synchronize(dev)
        rec = {"seconds": time.perf_counter() - t0,
               "launches": _counts_since(before),
               "collectives": comm.stats,
               "pod_collectives": dict(rf.aggregate.pod.stats),
               "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
               "losses": aux["losses"].cpu().tolist(),
               "rel": float(aux["rel"])}
        mine = sp.gather(rows)
        del rows
        # both pods' shared rows equal bit for bit: a checksum of this
        # rank's whole row, compared across the pods by the parent
        rec["row_sum"] = float(sum(t.double().sum() for t in leaves(mine)))
        if rank == 0:
            sim = steps.make_fused_round_step(cfg, ccfg, device=dev,
                                              codec=codec)
            s, _, saux = sim(tree_map(torch.clone, stacked), (), rb, 0)
            rec["gap_params"] = max(float((a - b[0]).abs().max())
                                    for a, b in zip(leaves(mine),
                                                    leaves(s)))
            rec["gap_losses"] = float((aux["losses"] - saux["losses"])
                                      .abs().max())
            rec["gap_rel"] = abs(float(aux["rel"]) - float(saux["rel"]))
            del s, sim
        del mine
        out[codec] = rec
        dist.barrier()
    # the flat int8 aggregate alone from the same rows on both paths: a
    # round's local step on the mesh differs from the unsharded one in
    # the last bits, which may flip an int8 rounding (phase 15's pitfall)
    from repro_torch.core import api
    before = ops.launch_counts()
    agg = api.FullAverage().make_aggregate_fn(api.FlatFusedInt8(), mesh=mesh)
    mine = sp.gather(agg(sp.distribute(stacked, pspecs, mesh)))
    rec = {"launches": _counts_since(before),
           "row_sum": float(sum(t.double().sum() for t in leaves(mine)))}
    if rank == 0:
        want = api.FullAverage().make_aggregate_fn(api.FlatFusedInt8())(
            tree_map(torch.clone, stacked))
        rec["gap_params"] = max(float((a - b[0]).abs().max())
                                for a, b in zip(leaves(mine), leaves(want)))
        out["int8_bound"] = max(float(t.abs().max())
                                for t in leaves(stacked)) / 127.0 + 1e-6
        del want
    out["fused_aggregate"] = rec
    dist.barrier()
    return out


def _ip17_rank(rank, world, out_dir, queue, dev_type):
    """One rank of phase 17, a spawned process: the probe, (a) and (b);
    puts its report (or its traceback) on ``queue``. A crash leaves the
    rank's stacks in ``fault<rank>.txt`` for the parent to report."""
    import faulthandler
    import traceback
    fault = open(f"{out_dir}/fault{rank}.txt", "w")
    faulthandler.enable(file=fault, all_threads=True)
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch import mesh as mesh_mod
        dev = mesh_mod.init_process_mesh(rank, world,
                                         f"file://{out_dir}/rdv", "staged",
                                         dev_type)
        report = {}
        try:
            report["probe"] = _probe17(torch, dist, rank, dev)
            Path(f"{out_dir}/probe{rank}.json").write_text(
                json.dumps(report["probe"]))
            t0 = time.perf_counter()
            m = mesh_mod.make_sim_mesh((2, 2), ("data", "model"), dev_type)
            report["a"] = _ip17_a(torch, rank, dev, m)
            report["a"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            m = mesh_mod.make_sim_mesh((2, 1, 2), ("pod", "data", "model"),
                                       dev_type)
            report["b"] = _ip17_b(torch, rank, dev, m)
            report["b_seconds"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", report))
    except Exception:                  # the parent reports it and fails
        queue.put((rank, "error", traceback.format_exc()))


def phase_intrapod(torch, dev, launches_out, mark):
    """Phase 17: the intra-pod mesh (see the comment above)."""
    import multiprocessing as mp
    import queue as queue_mod
    from repro_torch.models import xlstm
    out_dir = ROOT / "build" / "ip17"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    xlstm.release_slstm_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_ip17_rank, daemon=True, args=(
        k, IP_RANKS, str(out_dir), q, dev.type)) for k in range(IP_RANKS)]
    t0 = time.time()
    for p in procs:
        p.start()
    reports, errors = {}, []
    try:
        while len(reports) < IP_RANKS and not errors:
            try:
                k, status, payload = q.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.time() - t0 > IP17_TIMEOUT:
                    errors.append(f"ranks exited {dead} or timed out")
                continue
            if status == "ok":
                reports[k] = payload
            else:
                errors.append(f"rank {k}: {payload}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    faults = [(out_dir / f"{f}{k}.{x}").read_text()[:2500]
               for k in range(IP_RANKS) for f, x in (("probe", "json"),
                                                    ("fault", "txt"))
               if (out_dir / f"{f}{k}.{x}").exists()]
    shutil.rmtree(out_dir, ignore_errors=True)
    check(not errors, "17: " + (errors[0][-4000:] if errors else "")
          + "".join(f"\n{f}" for f in faults if f))
    seconds = time.time() - t0
    probe = {k: reports[k]["probe"] for k in (0, 1)}
    a = [reports[k]["a"] for k in range(IP_RANKS)]
    b = [reports[k]["b"] for k in range(IP_RANKS)]
    cfg = cfg17()
    say("intrapod", ranks=IP_RANKS, backend="staged (cpu:gloo, "
        "cuda:staged: collectives.StagedGroup)", probe=probe,
        reduced=f"n_layers 24 -> {LAYERS17} (four ranks share one card: "
                "each holds the full f32 params to place them, rank 0 "
                "the unsharded steps and the simulation path too); decode "
                f"steps 8 -> {DEC17} for the script's clock (each a "
                "host-bound step over the staged collectives)",
        d_model=cfg.d_model, vocab=cfg.vocab_size, batch=B17, seq_len=S17,
        decode_steps=DEC17, a=a, b=b, seconds=seconds,
        tolerance={"a": TOL17, "b": TOL15})
    r0 = a[0]
    check(r0["gap_train_params"]["rel"] <= 1 and r0["gap_train_loss"] <= 1,
          f"17a: the mesh train step is off the unsharded one: "
          f"{r0['gap_train_params']}, {r0['gap_train_loss']}")
    f64 = r0["prefill_err_vs_f64"]
    check(r0["gap_prefill"]["rel"] <= 1 or f64["mesh"] <= f64["unsharded"],
          f"17a: prefill gap {r0['gap_prefill']}, from f64 {f64}")
    check(max(g["rel"] for g in r0["gap_decode"]) <= 1,
          f"17a: decode gaps {r0['gap_decode']}")
    check(len({x["loss"] for x in a}) == 1, "17a: the ranks' losses differ")
    for codec in ("exact", "fused"):
        rec = b[0][codec]
        # the int8 round within one quantisation step (a flipped rounding,
        # see _ip17_b); its aggregate from equal rows at TOL15 below
        bound = TOL15 if codec == "exact" else b[0]["int8_bound"]
        check(rec["gap_params"] <= bound and rec["gap_rel"] <= 1e-5
              and rec["gap_losses"] <= 1e-5,
              f"17b {codec}: mesh vs simulation {rec['gap_params']}, "
              f"{rec['gap_losses']}, {rec['gap_rel']}")
        check(len({x[codec]["row_sum"] for x in b}) == 1,
              f"17b {codec}: the pods' shared rows differ")
        for k, x in enumerate(b):
            want = ({"wire_quantize": 1, "wire_dequantize": 1}
                    if codec == "fused" else {})
            check(x[codec]["launches"] == want,
                  f"17b {codec}: rank {k} launched {x[codec]['launches']}")
            for n, c in x[codec]["launches"].items():
                launches_out[n] = launches_out.get(n, 0) + c
    fa = [x["fused_aggregate"] for x in b]
    check(fa[0]["gap_params"] <= TOL15,
          f"17b: the int8 aggregate is off the simulation's by "
          f"{fa[0]['gap_params']}")
    check(len({x["row_sum"] for x in fa}) == 1,
          "17b: the int8 aggregate's rows differ between the pods")
    for k, x in enumerate(fa):
        check(x["launches"] == {"wire_quantize": 1, "wire_dequantize": 1},
              f"17b: rank {k}'s int8 aggregate launched {x['launches']}")
        for n, c in x["launches"].items():
            launches_out[n] = launches_out.get(n, 0) + c
    mark("17")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-3 at small shapes only (no result line)")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    # model-sized allocations of varying size: growable segments keep the
    # caching allocator from stranding memory between them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    marks = [("start", t_start)]

    def mark(phase):
        marks.append((phase, time.time()))
    name, smi = phase_device(torch)
    phase_build()
    mark("1-2 device, build")
    errs = {k: 0.0 for k in KERNEL_META}
    phase_kernels_small(torch, dev, errs)
    phase_flash_small(torch, dev, errs)
    phase_mlstm_small(torch, dev, errs)
    phase_scan_small(torch, dev, errs)
    phase_decode_small(torch, dev, errs)
    mark("3 small shapes")
    if args.quick:
        return 0
    bw = mem_bandwidth(name)
    timing = phase_kernels_full(torch, dev, errs, bw)
    timing["flash_attention"] = phase_flash_full(torch, dev, errs, name, bw,
                                                 FA_PATH, 4)
    timing["flash_attention_jamba"] = phase_flash_full(
        torch, dev, errs, name, bw, FA_PATH_JAMBA, 12)
    for seed, (arch, shape) in enumerate(FA_PATH_NEW.items(), 30):
        timing[f"flash_attention_{arch}"] = phase_flash_full(
            torch, dev, errs, name, bw, shape, seed)
    timing["mlstm"] = phase_mlstm_full(torch, dev, errs, name, bw)
    timing["selective_scan"] = phase_scan_full(torch, dev, errs, name, bw)
    timing["decode_attention"] = phase_decode_full(torch, dev, errs, bw)
    mark("3 path shapes")
    phase_small_round(torch, dev)
    phase_small_strategies(torch, dev)
    phase_small_membership(torch, dev)
    phase_small_continuous(torch, dev)
    mark("4")

    launches = {}
    # 5(a) under the python engine first, for the side-by-side numbers;
    # its launches are not the fused main path's, so they are not counted
    rounds_py, c_py = phase_main(torch, dev, "5a-python",
                                 api.get_codec("fused"), 5, 2, {},
                                 engine="python")
    mark("5a python")
    rounds_a, c_a = phase_main(torch, dev, "5a", api.get_codec("fused"),
                               5, 3, launches)
    mark("5a")
    for label, rounds, counts in (("5a-python", rounds_py, c_py),
                                  ("5a", rounds_a, c_a)):
        check(counts["wire_quant_avg_dequant"] == len(rounds),
              f"{label}: K3 launched {counts['wire_quant_avg_dequant']} "
              f"times for {len(rounds)} synced rounds")
        check(rounds[1]["local_loss"] < rounds[0]["local_loss"],
              f"{label}: loss did not fall ({rounds[0]['local_loss']} -> "
              f"{rounds[1]['local_loss']})")
    _, c_b = phase_main(torch, dev, "5b", api.get_codec(
        "fused", bits=4, error_feedback=True), 3, 2, launches)
    check(c_b["wire_quant_avg_dequant_ef"] == 2,
          "5b: K4 not launched once per round")
    mark("5b")
    _, c_c = phase_main(torch, dev, "5c", api.get_codec("leafwise"), 3, 2,
                        launches)
    n_leaves = RECORD["main"][-1]["quantized_leaves"]
    check(c_c["wire_quantize"] == c_c["wire_dequantize"] == 2 * n_leaves,
          f"5c: K1/K2 launched {c_c['wire_quantize']} / "
          f"{c_c['wire_dequantize']} times, not {n_leaves} per round")
    mark("5c")
    phase_serving(torch, dev, launches, timing["flash_attention"]["ms"], bw)
    mark("6")
    phase_xlstm_serving(torch, dev, launches, timing["mlstm"]["ms"], bw)
    mark("7")
    phase_jamba_serving(torch, dev, launches,
                        timing["selective_scan"]["ms"], bw)
    mark("8")
    phase_gated(torch, dev, launches)
    mark("9a")
    phase_partial_ragged(torch, dev, launches)
    mark("9b")
    phase_churn_gossip(torch, dev, launches)
    mark("10")
    phase_continuous(torch, dev, launches)
    mark("11a")
    phase_continuous_cli(torch)
    mark("11b")
    phase_examples(torch)
    mark("11d")
    phase_paper_tasks(torch, dev, launches, mark)
    phase_new_archs(torch, dev, launches, bw, mark)
    phase_recurrent_training(torch, dev, launches, mark)
    phase_pod(torch, dev, launches, mark)
    phase_remat(torch, dev, launches, smi, mark)
    phase_intrapod(torch, dev, launches, mark)

    kernels = []
    for kname, (tag, replaces, source) in KERNEL_META.items():
        t = timing[kname]
        kernels.append({
            "name": f"{kname} ({tag})", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            **({"bound_f32_cuda_ms": t["bound_f32_cuda_ms"]}
               if "bound_f32_cuda_ms" in t else {})})
    RECORD["kernels"] = kernels
    RECORD["seconds"] = time.time() - t_start
    RECORD["phase_seconds"] = {p: t - t0 for (_, t0), (p, t)
                               in zip(marks, marks[1:])}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1,
                                                    default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
