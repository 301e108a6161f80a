"""ServeLoop: batched cached decode with between-round hot-swap.

Ported from ``repro/serving/loop.py``. One ``ServeLoop`` owns ONE decode
step for a fixed config, batch and cache geometry. Where JAX jits the step
behind ``no_retrace(limit=1)``, the port captures it as a CUDA graph
(``core/graphs.py``, with ``limit=1``) when the loop is built, on the
loop's own buffers:

* the cache (``transformer.init_cache``: a KV cache for attention
  layers, the conv tail and SSM state for Mamba layers, the recurrent
  state for xLSTM layers), made once and given back its initial values
  in place (``transformer.reset_cache_``) for each prompt batch;
* a (B, 1) int64 token buffer and a 0-d int32 position buffer, into
  which each step's token and position are copied on the device (the
  positions are slices of one device tensor made in ``__init__``, and
  the next token is an argmax on the device), so nothing on the decode
  loop waits for the host;
* the params the loop was built with, which it takes over: a hot swap
  copies the new version into their storage (the graph reads it by
  address) instead of re-pointing the loop. A caller that needs the old
  version after a swap passes a clone.

Every prompt token and every decode token replays that one graph.
``compile_count()`` counts captures through ``analysis.guards.
compile_count``, as the reference counts compiles: 1 for the loop's life.
A call that would capture again (the params, cache or buffers moved)
raises ``graphs.RecaptureError``, an ``analysis.guards.RetraceError``.
The graph's logits are overwritten by its next replay: ``prefill``
returns a clone, and ``generate`` takes the argmax before the next
replay. On the CPU (only when asked for) the same step runs uncaptured
through ``GraphSet``'s CPU path. ``generate`` synchronises once, at its
end, for its timing (where JAX calls ``block_until_ready``).

Spans (``repro_torch.spans``, off by default): ``rt.serve.prefill`` and
``rt.serve.decode`` around ``generate``'s two phases and ``rt.serve.step``
around each replay. While tracing is on, ``generate`` records one CUDA
event after each decode replay and its stats carry ``step_ms``: the
device ms between consecutive decode replays' ends (``new_tokens - 1``
gaps).
"""
from __future__ import annotations

import time

import torch

from repro_torch import spans
from repro_torch.analysis import guards
from repro_torch.core.graphs import GraphSet
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves, leaves_with_path


def _tree_signature(params):
    """(leaf paths, (shape, dtype, device) per leaf) — the swap contract."""
    return (tuple(path for path, _ in leaves_with_path(params)),
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in leaves(params)))


def _decode_fn(cfg):
    # closes over the config only: the loop is not kept alive by its graph
    def step(params, cache, token, pos):
        return tr.decode_step(params, cfg, cache, token, pos)[0]
    return step


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

    The loop takes over ``params``: its graph reads their storage, and
    ``swap`` overwrites it with each new version (``self.params`` stays
    those tensors, with the new values).
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
        self._cache = tr.init_cache(cfg, self.batch, self.max_seq, dtype,
                                    self.device)
        self._token = torch.zeros((self.batch, 1), dtype=torch.int64,
                                  device=self.device)
        self._pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self.graphs = GraphSet(self.device)
        self._step = self.graphs.capture(_decode_fn(cfg),
                                         "ServeLoop decode step", limit=1)
        self._run_step()          # the capture (prefill resets the cache)
        #: lifetime counters for tokens/s during training
        self.tokens_served = 0
        self.batches_served = 0

    def _run_step(self):
        with spans.span("rt.serve.step"):
            return self._step(self.params, self._cache, self._token,
                              self._pos)

    # -- hot swap ------------------------------------------------------------
    def compile_count(self) -> int:
        """Captures of the decode step (1 for the loop's life: params are
        read by address, and a swap copies into them)."""
        return guards.compile_count(self._step)

    def replay_count(self) -> int:
        """Replays of the captured decode step (one per prompt token and
        per decode token; 0 on the CPU, where nothing is captured)."""
        return self._step.replays

    def swap(self, params, version: int) -> None:
        """Copy new params (same tree, shapes, dtypes and device) into the
        loop's own, on the stream the loop replays on; ``params`` is only
        read."""
        if _tree_signature(params) != self._signature:
            raise ValueError(
                "hot-swap params have a different treedef/shapes (or dtypes "
                "or device) than the decode step was built for; publish a "
                "matching model or build a new loop")
        pairs = [(dst, src) for dst, src in zip(leaves(self.params),
                                                leaves(params))
                 if dst is not src]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
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
        time, from the reset cache; returns (a clone of the last logits
        (B, 1, V), the loop's cache)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if prompts.shape[0] != self.batch:
            raise ValueError(f"prompt batch {prompts.shape[0]} != loop "
                             f"batch {self.batch}")
        tr.reset_cache_(self.cfg, self._cache)
        logits = None
        for t in range(prompts.shape[1]):
            self._token.copy_(prompts[:, t:t + 1])
            self._pos.copy_(self._positions[t])
            logits = self._run_step()
        return (None if logits is None else logits.clone()), self._cache

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, new_tokens: int):
        """Greedy-decode ``new_tokens`` continuations for a prompt batch.

        Returns ``(tokens (B, new_tokens), stats)`` where stats carries
        prefill/decode wall seconds, tokens/s, and the served version;
        while tracing is on (``repro_torch.spans``) and on a card, also
        ``step_ms``, the device ms between consecutive decode replays'
        ends.
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
        with spans.span("rt.serve.prefill"):
            logits, _ = self.prefill(prompts)
        self._sync()
        t1 = time.perf_counter()
        out, ends = [], []
        stamped = spans.enabled() and self.device.type == "cuda"
        tok = torch.argmax(logits, -1)
        with spans.span("rt.serve.decode"):
            for i in range(new_tokens):
                out.append(tok)
                self._token.copy_(tok)
                self._pos.copy_(self._positions[P + i])
                logits = self._run_step()
                if stamped:
                    ends.append(spans.stamp(self.device))
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
        if stamped:
            stats["step_ms"] = [a.elapsed_time(b)
                                for a, b in zip(ends, ends[1:])]
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
