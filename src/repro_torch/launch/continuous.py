"""Continuous-operation driver: train on a drifting stream, serve between
rounds. Ported from ``repro/launch/continuous.py``: the same flags, header
and round lines, plus ``--device {cuda,cpu}`` (default cuda; without a
card it raises unless ``--device cpu`` is given).

Closes the train->serve loop: each communication round trains on that
round's ``ShardStream`` snapshot (concept drift as a scenario axis), the
synced shared model is published into a ``ModelBank``, and a ``ServeLoop``
hot-swaps the newest version into its captured decode step and serves a
prompt batch — all in one process. The round's batches are staged on the
device (``engine.stage``); on the fused engine (the default) a drifted
round copies them into the captured round graph's static inputs, so
drift captures nothing. The loop is built on its own copy of the shared
model (it takes over the params it is built with, and a swap copies into
them), and on the card ``swap Nms`` is timed between two synchronisations
(the swap is asynchronous copies).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.continuous --device cpu \\
      --participants 3 --rounds 6 --drift abrupt --drift-round 3 \\
      --sync-policy divtrigger
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api
from repro_torch.core.colearn import CoLearner
from repro_torch.data.stream import ShardStream, get_drift
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.launch.train import (epoch_batches_fn, make_loss_fn,
                                      require_token_inputs)
from repro_torch.models import transformer as tr
from repro_torch.serving import ModelBank, ServeLoop


def drift_from_flags(args):
    """Map the CLI drift flags onto a DriftSchedule instance."""
    if args.drift == "none":
        return get_drift(None)
    if args.drift == "abrupt":
        return get_drift("abrupt", at_round=args.drift_round,
                         severity=args.drift_severity)
    return get_drift(args.drift, rate=args.drift_rate)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes; cuda raises without a "
                         "card (there is no silent CPU fallback)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--participants", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--t0", type=int, default=2)
    ap.add_argument("--eta0", type=float, default=0.01)
    ap.add_argument("--epsilon", type=float, default=0.05)
    ap.add_argument("--sync-policy", default="ile",
                    choices=["ile", "fle", "divtrigger"])
    ap.add_argument("--trigger-delta", type=float, default=0.05)
    ap.add_argument("--engine", default="fused", choices=["fused", "python"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--n-examples", type=int, default=480)
    ap.add_argument("--steps-per-epoch", type=int, default=0)
    ap.add_argument("--drift", default="none",
                    choices=["none", "covariate", "label_shift", "abrupt"],
                    help="concept-drift schedule for the shard stream "
                         "(repro_torch.data.stream registry)")
    ap.add_argument("--drift-rate", type=float, default=0.1,
                    help="per-round drift rate (covariate | label_shift)")
    ap.add_argument("--drift-round", type=int, default=3,
                    help="task-switch round for --drift abrupt")
    ap.add_argument("--drift-severity", type=float, default=1.0,
                    help="relabeled label-space fraction for --drift abrupt")
    ap.add_argument("--publish-on", default="synced",
                    choices=["synced", "always"],
                    help="bank publication policy: synced = keep serving "
                         "the stale shared model through quiet rounds")
    ap.add_argument("--bank-dir", default="",
                    help="persist published versions here (checkpoint/io)")
    ap.add_argument("--serve-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.max_seq < args.prompt_len + args.new_tokens:
        ap.error(f"--max-seq {args.max_seq} < --prompt-len {args.prompt_len}"
                 f" + --new-tokens {args.new_tokens}: decode would index "
                 "past the KV cache")
    if args.drift_rate != 0.1 and args.drift not in ("covariate",
                                                     "label_shift"):
        ap.error("--drift-rate requires --drift covariate|label_shift")
    if ((args.drift_round != 3 or args.drift_severity != 1.0)
            and args.drift != "abrupt"):
        ap.error("--drift-round/--drift-severity require --drift abrupt")
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    require_token_inputs(ap, cfg)
    K = args.participants
    drift = drift_from_flags(args)
    x, y = lm_examples(args.seed, args.n_examples, args.seq_len,
                       cfg.vocab_size)
    stream = ShardStream([x, y], K, args.batch_size, args.seed, drift=drift)
    ex, ey = lm_examples(args.seed + 99, 128, args.seq_len, cfg.vocab_size)

    ccfg = CoLearnConfig(n_participants=K, T0=args.t0, eta0=args.eta0,
                         epsilon=args.epsilon, max_rounds=args.rounds)
    sync_policy = api.get_sync_policy(args.sync_policy, ccfg,
                                      delta=args.trigger_delta)
    # ragged shards: the mask follows the batches' truncation
    batch_mask = stream.batch_mask if stream.ragged else None
    if batch_mask is not None and args.steps_per_epoch:
        batch_mask = batch_mask[:, :args.steps_per_epoch]
    learner = CoLearner(ccfg, make_loss_fn(cfg), round_engine=args.engine,
                        sync_policy=sync_policy, device=device,
                        shard_sizes=stream.sizes, batch_mask=batch_mask)
    params = tr.init_params(args.seed, cfg, torch.float32, device=device)
    state = learner.init(params)
    del params

    bank = ModelBank(mode="shared", publish_on=args.publish_on,
                     dir=args.bank_dir or None)
    bank.publish(learner.shared_model(state), round_i=0)  # v1 = init model
    # the loop takes over its params: its own copy, never the bank's
    serve = ServeLoop(cfg, learner.shared_model(state),
                      batch=args.serve_batch, max_seq=args.max_seq,
                      device=device)
    serve.poll(bank)
    prompts = torch.as_tensor(
        np.random.default_rng(args.seed + 7).integers(
            0, cfg.vocab_size, (args.serve_batch, args.prompt_len)),
        device=device)

    print(f"continuous {cfg.name}: K={K} rounds={args.rounds} "
          f"drift={drift.name} sync={learner.sync_policy.name} "
          f"publish_on={args.publish_on} engine={args.engine}", flush=True)

    batches = epoch_batches_fn(stream, device, args.steps_per_epoch)
    for _ in range(args.rounds):
        t0 = time.time()
        state = learner.run_round(state, batches,
                                  on_round_end=bank.publish_from)
        _sync(device)
        swap_t0 = time.time()
        swapped = serve.poll(bank)
        _sync(device)
        swap_ms = (time.time() - swap_t0) * 1e3
        _, stats = serve.generate(prompts, args.new_tokens)
        log = state["log"][-1]
        # honest eval: the held-out set as THIS round's distribution sees it
        dx, dy = stream.transform_test((ex, ey), state["round"])
        with torch.no_grad():
            loss, _ = tr.loss_fn(
                bank.current().params, cfg,
                {"tokens": torch.as_tensor(dx[:64], device=device),
                 "labels": torch.as_tensor(dy[:64], device=device)})
        print(f"round {log.round}: T={log.T} "
              f"local_loss={np.mean(log.local_losses):.4f} "
              f"serve_loss={float(loss):.4f} v{serve.version} "
              f"stale={bank.staleness(state['round'])} "
              f"{'swap %.1fms' % swap_ms if swapped else 'no-swap'} "
              f"{stats['tokens_per_s']:.0f} tok/s "
              f"compiles={serve.compile_count()}"
              f"{'' if log.synced else ' SKIP(sync)'} "
              f"({time.time()-t0:.1f}s)", flush=True)

    assert serve.compile_count() == 1, "hot swaps must not recapture decode"
    print(f"served {serve.tokens_served} tokens across "
          f"{serve.batches_served} batches while training "
          f"{args.rounds} rounds; final version v{serve.version}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
