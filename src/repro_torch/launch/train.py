"""End-to-end co-learning training entry point, ported from
``repro/launch/train.py``: the same flags and per-round line, plus
``--device {cuda,cpu}`` (default cuda; without a card it raises unless
``--device cpu`` is given).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
      --arch internlm2-1.8b --participants 5 --rounds 3 --t0 1 \\
      --codec fused --steps-per-epoch 2

Ported: the exact / leafwise / fused codecs at 8/4/1 bits with error
feedback, the full Eq. 2 aggregator (``--weighted-avg`` included) and
partial participation (``--aggregator partial --partial-m``), both round
engines (``--engine fused``, the default as in the JAX CLI: every round
as replays of CUDA graphs captured once; ``--engine python``: the host
loop), the clr/elr/warmup_clr/cosine schedules, the ile/fle policies and
the divergence trigger (``--sync-policy divtrigger --trigger-delta``;
quiet rounds print ``SKIP(sync)`` and bill 0 bytes), and the iid,
dirichlet and sizes partitions (ragged shards train under their batch
mask), the gossip aggregators (``--aggregator ring|graph|d2`` over every
registered ``--topology``, ``--er-p``/``--er-seed`` for erdos_renyi),
elastic membership (``--churn scripted --churn-events
crash:1:1,rejoin:3:1`` or ``--churn random --churn-p --churn-seed``,
``--k-max`` standby slots, the ``--naive-membership`` ablation; churned
rounds print ``live=n/K``) and ``--checkpoint PATH``, which saves the
round state after the last round in the format
``repro/checkpoint/io.py`` reads. ``--arch`` takes every registered
architecture's smoke config, except a ``tokens+prefix`` one (internvl2-76b):
the synthetic LM corpus has no prefix embeddings to feed it, so the CLI
stops before the first round and names the missing prefix (the JAX CLI
fails on it with ``KeyError: 'prefix'`` inside the first step).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.io import save_round_state
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api
from repro_torch.core import membership as membership_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.data import partition as part_mod
from repro_torch.data.pipeline import ParticipantData
from repro_torch.data.synthetic import lm_examples
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves


def build_data(cfg, K, batch_size, seq_len, n_examples, seed=0,
               partition="iid", dirichlet_alpha=0.5, sizes=None,
               drop_remainder=False, k_max=None):
    """Shard the synthetic LM corpus under the chosen data scenario:
    "iid" (the paper's random split), "dirichlet" (label skew over the
    first target token bucketed into 10 classes) or "sizes" (quantity
    skew with the given counts or fractions). ``k_max`` pads the slot
    list with standby slots that cycle the real shards."""
    x, y = lm_examples(seed, n_examples, seq_len, cfg.vocab_size)
    idx = part_mod.scenario_indices(
        len(x), K, seed, scenario=partition, labels=y[:, 0] % 10,
        dirichlet_alpha=dirichlet_alpha, sizes=sizes, min_size=batch_size,
        drop_remainder=drop_remainder)
    return ParticipantData(part_mod.shard_by_indices([x, y], idx),
                           batch_size, seed, k_max=k_max)


@torch.no_grad()
def eval_loss(params, cfg, x, y, batch=64):
    """Mean LM loss over whole batches of (x, y) (numpy int arrays)."""
    dev = leaves(params)[0].device
    tot, n = 0.0, 0
    for i in range(0, len(x) - batch + 1, batch):
        b = {"tokens": torch.as_tensor(x[i:i + batch], device=dev),
             "labels": torch.as_tensor(y[i:i + batch], device=dev)}
        loss, _ = tr.loss_fn(params, cfg, b)
        tot += float(loss) * batch
        n += batch
    return tot / max(n, 1)


def require_token_inputs(ap, cfg):
    """Stop the CLI (``ap.error``) for a config whose batches need more
    than tokens: the synthetic corpus makes no ``prefix``."""
    if cfg.input_mode != "tokens":
        ap.error(f"{cfg.name}: input_mode {cfg.input_mode!r} needs a "
                 f"'prefix' of (batch, {cfg.prefix_len}, {cfg.d_model}) "
                 "embeddings in every batch, and the synthetic LM corpus "
                 "has no prefix generator")


def make_loss_fn(cfg, remat=True):
    """``loss_fn(params, (tokens, labels))`` for one participant; the CLI
    takes ``transformer.loss_fn``'s default, per-layer recomputation on,
    as the reference's CLI does."""
    def loss_fn(params, batch):
        x, y = batch
        return tr.loss_fn(params, cfg, {"tokens": x, "labels": y},
                          remat=remat)
    return loss_fn


def epoch_batches_fn(data, device, steps_per_epoch=0):
    """(round, epoch) -> the (K, n_batches, B, S) token/label tensors on
    ``device``, truncated to ``steps_per_epoch`` batches when nonzero and
    staged through pinned memory (``engine.stage``: no host sync)."""
    def epoch_batches(round_i, epoch_j):
        bx, by = data.epoch_batches(round_i, epoch_j)
        if steps_per_epoch:
            bx, by = bx[:, :steps_per_epoch], by[:, :steps_per_epoch]
        return stage(bx, device=device), stage(by, device=device)
    return epoch_batches


def round_line(log, ev, next_T, seconds, k_live=None):
    """The round's line; ``k_live`` (the slot count, under churn) adds
    ``live=n/K``."""
    sync_s = "" if log.synced else " SKIP(sync)"
    if k_live is not None:
        sync_s += f" live={log.live}/{k_live}"
    return (f"round {log.round}: T={log.T} lr {log.lr_first:.4f}->"
            f"{log.lr_last:.4f} rel_dw={log.rel_change:.4f} "
            f"local_loss={np.mean(log.local_losses):.4f} eval={ev:.4f} "
            f"comm={log.comm_bytes/2**20:.1f}MiB next_T={next_T}"
            f"{sync_s} ({seconds:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes; cuda raises without a "
                         "card (there is no silent CPU fallback)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--participants", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--t0", type=int, default=2)
    ap.add_argument("--eta0", type=float, default=0.01)
    ap.add_argument("--epsilon", type=float, default=0.05)
    ap.add_argument("--schedule", default="clr", choices=["clr", "elr"])
    ap.add_argument("--epochs-rule", default="ile", choices=["ile", "fle"])
    ap.add_argument("--lr-schedule", default="",
                    choices=["", "clr", "elr", "warmup_clr", "cosine"])
    ap.add_argument("--sync-policy", default="",
                    choices=["", "ile", "fle", "divtrigger"])
    ap.add_argument("--trigger-delta", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--n-examples", type=int, default=1280)
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="truncate each epoch to this many batches (0=full)")
    ap.add_argument("--partition", default="iid",
                    choices=["iid", "dirichlet", "sizes"])
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--sizes", default="")
    ap.add_argument("--drop-remainder", action="store_true")
    ap.add_argument("--weighted-avg", action="store_true",
                    help="example-count-weighted Eq. 2 (FedAvg weighting)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "fused"],
                    help="legacy alias for --codec")
    ap.add_argument("--codec", default="",
                    choices=["", "exact", "leafwise", "fused"],
                    help="wire codec for uploads: exact f32 | leafwise "
                         "quantize-roundtrip (K1+K2 per leaf) | fused "
                         "flat-buffer (one K3 pass; K4 with EF)")
    ap.add_argument("--codec-bits", type=int, default=8, choices=[8, 4, 1])
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--aggregator", default="full",
                    choices=["full", "partial", "ring", "graph", "d2"])
    ap.add_argument("--partial-m", type=int, default=2)
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "grid2d", "torus", "hypercube",
                             "exponential", "erdos_renyi", "complete"])
    ap.add_argument("--er-p", type=float, default=0.5)
    ap.add_argument("--er-seed", type=int, default=0)
    ap.add_argument("--engine", default="fused", choices=["fused", "python"],
                    help="round engine: fused = every round as replays of "
                         "CUDA graphs captured once (core/graphs.py); "
                         "python = reference loop")
    ap.add_argument("--churn", default="none",
                    choices=["none", "scripted", "random"])
    ap.add_argument("--churn-events", default="")
    ap.add_argument("--churn-p", type=float, default=0.2)
    ap.add_argument("--churn-seed", type=int, default=0)
    ap.add_argument("--k-max", type=int, default=0)
    ap.add_argument("--naive-membership", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.codec and args.compress != "none":
        ap.error("pass --codec or the legacy --compress, not both")
    codec_spec = args.codec or args.compress
    if (args.codec_bits != 8 or args.error_feedback) and codec_spec in (
            "", "none", "exact"):
        ap.error("--codec-bits/--error-feedback require a quantizing codec "
                 "(--codec leafwise|fused or --compress int8|fused)")
    codec = api.get_codec(codec_spec, bits=args.codec_bits,
                          error_feedback=args.error_feedback)
    # a sample beyond the pool is a config bug, caught here instead of
    # inside the mixing-matrix draw
    if args.aggregator == "partial" and args.partial_m > args.participants:
        ap.error(f"--partial-m {args.partial_m} exceeds --participants "
                 f"{args.participants}")
    if args.aggregator == "partial" and args.partial_m < 1:
        ap.error("--partial-m must be >= 1")
    if args.topology != "ring" and args.aggregator not in ("graph", "d2"):
        ap.error("--topology requires --aggregator graph|d2")
    if ((args.er_p != 0.5 or args.er_seed)
            and args.topology != "erdos_renyi"):
        ap.error("--er-p/--er-seed require --topology erdos_renyi")
    if args.churn_events and args.churn != "scripted":
        ap.error("--churn-events requires --churn scripted")
    if (args.churn_p != 0.2 or args.churn_seed) and args.churn != "random":
        ap.error("--churn-p/--churn-seed require --churn random")
    if args.k_max and args.churn == "none":
        ap.error("--k-max requires --churn scripted|random (standby slots "
                 "only join through membership events)")
    if args.k_max and args.k_max < args.participants:
        ap.error(f"--k-max {args.k_max} smaller than --participants "
                 f"{args.participants}")
    k_max = args.k_max or args.participants
    churn = None
    if args.churn != "none":
        init_live = args.participants if k_max > args.participants else None
        if args.churn == "random":
            churn = membership_mod.RandomChurn(
                p_fail=args.churn_p, seed=args.churn_seed,
                initial_live=init_live)
        else:
            events = []
            for spec in filter(None, args.churn_events.split(",")):
                try:
                    kind, r, k = spec.split(":")
                    events.append((kind, int(r), int(k)))
                except ValueError:
                    ap.error(f"bad --churn-events entry {spec!r} "
                             "(want kind:round:slot)")
            try:
                churn = membership_mod.ScriptedChurn(
                    events=tuple(events), initial_live=init_live)
            except ValueError as e:
                ap.error(str(e))
    if args.naive_membership and churn is None:
        ap.error("--naive-membership requires --churn")

    cfg = get_smoke_config(args.arch)
    require_token_inputs(ap, cfg)
    K = k_max
    ccfg = CoLearnConfig(
        n_participants=K, T0=args.t0, eta0=args.eta0, epsilon=args.epsilon,
        schedule=args.schedule, epochs_rule=args.epochs_rule,
        max_rounds=args.rounds)
    # scenario flags must match --partition: an ignored one would let a
    # user believe they ran a skew they never ran
    if args.sizes and args.partition != "sizes":
        ap.error("--sizes requires --partition sizes")
    if not args.sizes and args.partition == "sizes":
        ap.error("--partition sizes requires --sizes")
    if args.dirichlet_alpha != 0.5 and args.partition != "dirichlet":
        ap.error("--dirichlet-alpha requires --partition dirichlet")
    if args.drop_remainder and args.partition != "iid":
        ap.error("--drop-remainder only applies to --partition iid")
    sizes = ([float(s) for s in args.sizes.split(",")] if args.sizes
             else None)
    data = build_data(cfg, args.participants, args.batch_size, args.seq_len,
                      args.n_examples, args.seed, partition=args.partition,
                      dirichlet_alpha=args.dirichlet_alpha, sizes=sizes,
                      drop_remainder=args.drop_remainder,
                      k_max=k_max if args.k_max else None)
    ex, ey = lm_examples(args.seed + 99, 256, args.seq_len, cfg.vocab_size)
    if args.weighted_avg and args.aggregator != "full":
        ap.error("--weighted-avg only applies to --aggregator full")
    if args.aggregator == "partial":
        aggregator = api.PartialParticipation(m=args.partial_m,
                                              seed=args.seed)
    elif args.weighted_avg:
        aggregator = api.FullAverage(weights=data.sizes)
    elif args.aggregator in ("graph", "d2"):
        if args.topology == "erdos_renyi":
            topo = topo_mod.ErdosRenyiTopology(p=args.er_p,
                                               seed=args.er_seed)
        else:
            topo = topo_mod.get_topology(args.topology)
        cls = api.D2Gossip if args.aggregator == "d2" else api.GraphGossip
        aggregator = cls(topology=topo)
    else:
        aggregator = api.get_aggregator(args.aggregator)
    # ragged shards (unequal batch counts): the validity mask goes into
    # the engines so every shard trains on exactly its own batches
    batch_mask = data.batch_mask if data.ragged else None
    if batch_mask is not None and args.steps_per_epoch:
        batch_mask = batch_mask[:, :args.steps_per_epoch]
    schedule = api.get_schedule(args.lr_schedule or None, ccfg)
    sync_policy = api.get_sync_policy(args.sync_policy or None, ccfg,
                                      delta=args.trigger_delta)
    learner = CoLearner(ccfg, make_loss_fn(cfg),
                        optimizer_name=args.optimizer, codec=codec,
                        aggregator=aggregator, round_engine=args.engine,
                        schedule=schedule, sync_policy=sync_policy,
                        device=device, shard_sizes=data.sizes,
                        batch_mask=batch_mask, churn=churn,
                        liveness_aware=not args.naive_membership)
    params = tr.init_params(args.seed, cfg, torch.float32, device=device)
    state = learner.init(params)
    del params
    shard_s = (f" shards={list(data.sizes)}" if args.partition != "iid"
               or data.ragged else "")
    if churn is not None:
        shard_s += (f" churn={learner.churn.name}"
                    + (f" k_max={k_max}" if args.k_max else "")
                    + (" naive" if args.naive_membership else ""))
    print(f"co-learning {cfg.name}: K={K} params="
          f"{tr.count_params(state['params']) // K:,} rounds={args.rounds} "
          f"T0={args.t0} {learner.schedule.name}+{learner.sync_policy.name} "
          f"engine={args.engine} codec={learner.codec.name} "
          f"aggregator={learner.aggregator.name} "
          f"partition={args.partition}{shard_s} device={device}",
          flush=True)

    batches = epoch_batches_fn(data, device, args.steps_per_epoch)
    for _ in range(args.rounds):
        t0 = time.time()
        state = learner.run_round(state, batches)
        log = state["log"][-1]
        ev = eval_loss(learner.shared_model(state), cfg, ex, ey)
        print(round_line(log, ev, state["ctrl"].T, time.time() - t0,
                         K if churn is not None else None), flush=True)
    if args.checkpoint:
        save_round_state(args.checkpoint, state)
        print(f"saved {args.checkpoint}.params.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
