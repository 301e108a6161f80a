"""ServeLoop: batched cached decode with between-round hot-swap.

Ported from ``repro/serving/loop.py``. One ``ServeLoop`` owns ONE decode
step, built once in ``__init__`` for a fixed config, batch and cache
geometry; the model parameters are plain arguments to it, so swapping to a
newly published ``ModelBank`` version is a reference update. Where JAX
jits the step behind ``no_retrace``, the port runs it eagerly:
``compile_count()`` counts decode-step builds, which is 1 for the loop's
life, and a swap never adds one (it only accepts params with the same tree
structure, leaf shapes, dtypes and device). Capturing the step as a CUDA
graph is later work (ROADMAP.md).

The cache is ``transformer.init_cache``'s: a KV cache for attention
layers, the conv tail and SSM state for Mamba layers, the recurrent state
for xLSTM layers, made anew for each prompt batch and updated in place by
the step. Prefill goes token by token
through the same step, as in the JAX loop. Positions are 0-d slices of
one device tensor made in ``__init__``, and the next token is an argmax on
the device, so nothing on the decode loop waits for the host;
``generate`` synchronises once, at its end, for its timing (where JAX
calls ``block_until_ready``).
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves, leaves_with_path


def _tree_signature(params):
    """(leaf paths, (shape, dtype, device) per leaf) — the swap contract."""
    return (tuple(path for path, _ in leaves_with_path(params)),
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in leaves(params)))


class ServeLoop:
    """Batched greedy decode against a per-layer cache, hot-swappable
    params.

    ``generate(prompts, new_tokens)`` checks that the prompt and the
    requested continuation fit the cache (``max_seq``) before touching the
    device, prefills through the step, then decodes greedily.
    ``poll(bank)`` swaps in the bank's current version when it is newer
    than what is being served; ``swap(params, version)`` is the low-level
    entry. ``device`` defaults to cuda and raises without a card unless
    ``"cpu"`` is passed; the params must lie on it.
    """

    def __init__(self, cfg, params, *, batch: int, max_seq: int,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.batch = int(batch)
        self.max_seq = int(max_seq)
        self.dtype = dtype
        # the device as tensors report it ("cuda:0", not "cuda")
        self.device = torch.empty(0, device=resolve_device(device)).device
        self._signature = _tree_signature(params)
        if any(dev != self.device for _, _, dev in self._signature[1]):
            raise ValueError(f"params must lie on {self.device}")
        self.params = params
        self.version = 0          # bank version currently served (0 = init)
        self._positions = torch.arange(self.max_seq, dtype=torch.int32,
                                       device=self.device)
        self._step_builds = 0
        self._step = self._build_step()
        #: lifetime counters for tokens/s during training
        self.tokens_served = 0
        self.batches_served = 0

    def _build_step(self):
        self._step_builds += 1
        cfg = self.cfg
        return lambda p, c, t, i: tr.decode_step(p, cfg, c, t, i)

    # -- hot swap ------------------------------------------------------------
    def compile_count(self) -> int:
        """Decode-step builds (1 for the loop's life: params are
        arguments of the step, never part of it)."""
        return self._step_builds

    def swap(self, params, version: int) -> None:
        """Point the loop at new params (same tree, shapes, dtypes and
        device)."""
        if _tree_signature(params) != self._signature:
            raise ValueError(
                "hot-swap params have a different treedef/shapes (or dtypes "
                "or device) than the decode step was built for; publish a "
                "matching model or build a new loop")
        self.params = params
        self.version = int(version)

    def poll(self, bank) -> bool:
        """Swap to the bank's current version if newer. Returns whether a
        swap happened. Ensemble-mode snapshots are not decodable (K
        stacked replicas, one cache): ``ModelBank.predict_logits`` serves
        those."""
        snap = bank.current()
        if snap is None:
            return False
        if snap.mode != "shared":
            raise ValueError(
                f"ServeLoop decodes a single shared model; bank publishes "
                f"mode={snap.mode!r} (use ModelBank.predict_logits for the "
                "ensemble serving path)")
        if snap.version <= self.version:
            return False
        self.swap(snap.params, snap.version)
        return True

    # -- decode --------------------------------------------------------------
    def prefill(self, prompts):
        """Prefill a (B, P) prompt batch through the step, one token at a
        time; returns (last logits (B, 1, V), cache)."""
        cache = tr.init_cache(self.cfg, prompts.shape[0], self.max_seq,
                              self.dtype, self.device)
        logits = None
        for t in range(prompts.shape[1]):
            logits, cache = self._step(self.params, cache,
                                       prompts[:, t:t + 1],
                                       self._positions[t])
        return logits, cache

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, new_tokens: int):
        """Greedy-decode ``new_tokens`` continuations for a prompt batch.

        Returns ``(tokens (B, new_tokens), stats)`` where stats carries
        prefill/decode wall seconds, tokens/s, and the served version.
        """
        prompts = torch.as_tensor(prompts, device=self.device)
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"prompt batch {B} != loop batch {self.batch}")
        if P + new_tokens > self.max_seq:
            raise ValueError(
                f"prompt_len {P} + new_tokens {new_tokens} overruns the "
                f"KV cache (max_seq={self.max_seq}) — decode would index "
                "past the cache")
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompts)
        self._sync()
        t1 = time.perf_counter()
        out = []
        tok = torch.argmax(logits, -1)
        for i in range(new_tokens):
            out.append(tok)
            logits, cache = self._step(self.params, cache, tok,
                                       self._positions[P + i])
            tok = torch.argmax(logits, -1)
        gen = torch.cat(out, dim=1)
        self._sync()
        t2 = time.perf_counter()
        self.tokens_served += B * new_tokens
        self.batches_served += 1
        decode_s = max(t2 - t1, 1e-9)
        stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                 "tokens": B * new_tokens,
                 "tokens_per_s": B * new_tokens / decode_s,
                 "version": self.version,
                 "compile_count": self.compile_count()}
        return gen, stats


def serve_rounds_stats(per_round):
    """Aggregate per-round ``generate`` stats dicts into one summary row
    (total tokens, mean tokens/s, served versions)."""
    toks = sum(s["tokens"] for s in per_round)
    secs = sum(s["decode_s"] for s in per_round)
    return {"rounds_served": len(per_round),
            "total_tokens": toks,
            "tokens_per_s_mean": toks / max(secs, 1e-9),
            "versions": [s["version"] for s in per_round]}
