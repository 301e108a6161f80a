"""Entry ``round``: ``CoLearner.run_round`` on the fused engine, the train
CLI's default: K participants' local SGD epochs (the paper's Algorithm 1,
the CLR rate of Eq. 3), then Eq. 2 over the flat int8 wire (one K3 pass).

Traffic parameters: ``participants``, ``steps_per_epoch``, ``batch``,
``seq_len``, ``epochs`` (T, fixed by the FLE rule), ``codec``,
``codec_bits``, ``block``, ``schedule``, ``eta0``, ``decay_rate``,
``remat``, ``checked_rounds``, ``traced_calls``. Every round's batches are
new rows of uniform token ids, drawn on the device from the seed and the
round's index (participant k's step s: row k of the round's draw).

Set-up builds the learner once from the benchmark's weights and runs its
first ``checked_rounds`` rounds through the window's own call and feed
(the first one captures the round's graph); the window continues with the
same learner. The check follows those first rounds with the plain
reference (``bench/reference/colearn.py``), one participant at a time,
once the program's state is freed: each round's loss, and each leaf's
norm of the shared model's change after the first round and after the
last checked one.
"""
from __future__ import annotations

import statistics

import torch

from bench import weights
from bench.harness import free_device, model_config
from bench.reference import colearn as ref_round

_STREAM = 1_000_003


def round_tokens(seed, round_i, t, device):
    """(tokens, labels), each (K, steps, B, S), of round ``round_i``."""
    shape = (t["participants"], t["steps_per_epoch"], t["batch"],
             t["seq_len"] + 1)
    seq = weights.tokens(seed, _STREAM, round_i, shape, t["vocab"], device)
    return seq[..., :-1], seq[..., 1:]


def leaf_change_norms(stacked_leaves, table, run):
    """Norm of (row 0 - the initial weights) of every leaf; the initial
    leaf is drawn again from the seed."""
    out = []
    for i, ((path, shape, dtype), t) in enumerate(zip(table,
                                                      stacked_leaves)):
        w0 = weights.leaf(run.ref, run.seed, i, path, shape, dtype,
                          run.device)
        out.append(float(torch.linalg.vector_norm(
            t[0] - w0, dtype=torch.float64)))
        del w0
    return out


def worst_leaf_gap(prog, ref, skip):
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref)."""
    keep = [i for i in range(len(ref)) if i not in skip]
    med = statistics.median(ref[i] for i in keep)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep)


class Driver:
    def __init__(self, run):
        self.run = run
        self.t = dict(run.traffic)
        self.t["vocab"] = run.config["model"]["vocab_size"]
        self.traced_calls = self.t["traced_calls"]

    def tokens_per_round(self):
        t = self.t
        return (t["participants"] * t["steps_per_epoch"] * t["batch"]
                * t["seq_len"] * t["epochs"])

    def attempted(self, calls):
        return calls

    def _batches(self, round_i, epoch_j):
        return round_tokens(self.run.seed, round_i, self.t, self.run.device)

    def setup(self):
        from repro_torch.configs.base import CoLearnConfig
        from repro_torch.core import api
        from repro_torch.core.colearn import CoLearner
        from repro_torch.launch import train as train_mod
        from repro_torch.tree import leaves
        run, t = self.run, self.t
        self.cfg = model_config(run.config)
        self.table = weights.shapes(self.cfg)
        ccfg = CoLearnConfig(
            n_participants=t["participants"], T0=t["epochs"],
            eta0=t["eta0"], decay_rate=t["decay_rate"],
            schedule=t["schedule"], epochs_rule="fle",
            max_rounds=t["checked_rounds"])
        self.learner = CoLearner(
            ccfg, train_mod.make_loss_fn(self.cfg, remat=t["remat"]),
            codec=api.get_codec(t["codec"], block=t["block"],
                                bits=t["codec_bits"]),
            round_engine="fused", device=run.device)
        params = weights.make(run.ref, self.table, run.seed, run.device)
        self.state = self.learner.init(params)
        del params
        self.prog_losses, self.prog_norms = [], {}
        for r in range(t["checked_rounds"]):
            self.call(r)
            log = self.state["log"][-1]
            self.prog_losses.append(float(log.local_losses[0]))
            if r in (0, t["checked_rounds"] - 1):
                self.prog_norms[r] = leaf_change_norms(
                    leaves(self.state["params"]), self.table, run)

    def call(self, i):
        self.state = self.learner.run_round(self.state, self._batches)
        return self.tokens_per_round()

    def release(self):
        log = self.state["log"][-1]
        self.run.counters["comm_bytes"] = log.comm_bytes
        del self.state, self.learner
        free_device()

    def reference_rounds(self, low=False, average=True, rows=None):
        """(losses, change norms after the first and the last checked
        round, leaves left out) of the reference over the checked rounds;
        ``rows`` keeps only that many rows of every batch (a fault)."""
        run, t = self.run, self.t
        arch = run.config["model"]
        params = weights.make(run.ref, self.table, run.seed, run.device)
        losses, norms, first = [], {}, None
        for r in range(t["checked_rounds"]):
            x, y = round_tokens(run.seed, r, t, run.device)
            sl = slice(None) if rows is None else slice(0, rows)

            def batches(k, s, _x=x, _y=y):
                return _x[k, s, sl], _y[k, s, sl]
            params, loss, grads = ref_round.run_round(
                run.ref, params, arch, batches,
                participants=t["participants"],
                steps=t["steps_per_epoch"], lr=t["eta0"], block=t["block"],
                bits=t["codec_bits"], low=low, average=average)
            first = first or grads
            losses.append(loss)
            if r in (0, t["checked_rounds"] - 1):
                new = ref_round.tree_leaves(params)
                norms[r] = leaf_change_norms([n[None] for n in new],
                                             self.table, run)
        med = statistics.median(first)
        skip = {i for i, g in enumerate(first) if g < 1e-3 * med}
        del params
        free_device()
        return losses, norms, skip

    def check(self):
        losses, norms, skip = self.reference_rounds()
        return self.compare(self.prog_losses, self.prog_norms, losses,
                            norms, skip)

    def compare(self, p_losses, p_norms, r_losses, r_norms, skip):
        last = self.t["checked_rounds"] - 1
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(p_losses, r_losses)),
            "update1_gap": worst_leaf_gap(p_norms[0], r_norms[0], skip),
            f"update{last + 1}_gap": worst_leaf_gap(p_norms[last],
                                                    r_norms[last], skip),
        }
