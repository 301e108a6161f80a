"""Elastic membership, ported from ``repro/core/membership.py`` (numpy
only; the port keeps its own copy): per-round participant liveness over
``K_max`` slots.

* :class:`Membership` — the host-side state: which of the ``K_max``
  participant *slots* are live right now, plus the join/leave event log.
  It lives in the learner's round state (``state["membership"]``), is
  persisted by ``checkpoint/io.py`` (legacy checkpoints restore as
  all-live), and advances once per round via :meth:`Membership.step`.

* :class:`ChurnSchedule` — WHO is live each round, as a pure function
  ``live_mask(round_i, K) -> bool (K,)`` so the python and fused engines
  (and a resumed run, and the JAX package) see identical membership
  traces. Built-ins: :class:`NoChurn` (the static-K paper path: the
  learner bypasses the membership machinery entirely),
  :class:`ScriptedChurn` (deterministic fault injection: crash at round
  r, rejoin at round r', flaky slots, standby slots) and
  :class:`RandomChurn` (i.i.d. per-round failures and rejoins,
  deterministic in ``(seed, round)``).

A dead slot is NOT removed from the stacked ``(K, ...)`` tensors: the
fused engine's captured graphs read fixed shapes at fixed addresses.
The liveness mask rides into the rounds as one ``(K,)`` f32 device
tensor (``core/engine.py``), composed with the ragged-shard batch mask:
a dead row is an identity carry through the local epochs AND the
aggregation (it neither uploads, nor downloads, nor counts in the mean;
the aggregators renormalise their mixing matrices over the live set,
``core/api.py``). A membership change therefore never captures again; a
rejoin warm-starts through ``CoLearner.restart_participant`` from the
last *synced* shared model.

Schedules whose :attr:`~ChurnSchedule.is_static` is True (``NoChurn``, an
event-free ``ScriptedChurn``, a ``RandomChurn`` that can never kill a
slot) keep the learner on the static-K code path, so "all-live" reduces
to it bit for bit, by construction.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np

#: membership event kinds as logged by :meth:`Membership.step`
JOIN = "join"
LEAVE = "leave"


@dataclasses.dataclass(frozen=True)
class Membership:
    """Live mask over the ``K_max`` participant slots + join/leave log.

    ``live`` is the CURRENT per-slot liveness (a tuple of bools, length
    ``K_max``); ``events`` logs every transition as ``(round, slot, kind)``
    triples with kind ``"join"`` | ``"leave"`` (slots live at round 0 log
    no synthetic join). The dataclass is immutable — :meth:`step` returns
    the advanced copy — so checkpoints and the round log can hold
    references safely.
    """

    live: tuple
    events: tuple = ()

    @classmethod
    def all_live(cls, K: int) -> "Membership":
        return cls(live=(True,) * K)

    @property
    def k_max(self) -> int:
        return len(self.live)

    @property
    def n_live(self) -> int:
        return sum(self.live)

    def live_mask(self) -> np.ndarray:
        """The current liveness as a bool ``(K_max,)`` numpy row."""
        return np.asarray(self.live, bool)

    def live_slots(self) -> tuple:
        return tuple(k for k, a in enumerate(self.live) if a)

    def step(self, round_i: int, new_live) -> "Membership":
        """Advance to ``new_live`` for round ``round_i``, logging every
        slot that flipped. Returns the new Membership; the joins/leaves of
        a specific round are recoverable via :meth:`round_events`."""
        new_live = tuple(bool(a) for a in np.asarray(new_live).reshape(-1))
        if len(new_live) != self.k_max:
            raise ValueError(
                f"live mask has {len(new_live)} slots; membership tracks "
                f"K_max={self.k_max}")
        ev = []
        for k, (was, now) in enumerate(zip(self.live, new_live)):
            if was != now:
                ev.append((round_i, k, JOIN if now else LEAVE))
        return dataclasses.replace(self, live=new_live,
                                   events=self.events + tuple(ev))

    def round_events(self, round_i: int) -> tuple:
        """The ``(round, slot, kind)`` events logged at ``round_i``."""
        return tuple(e for e in self.events if e[0] == round_i)

    def joined(self, round_i: int) -> tuple:
        return tuple(e[1] for e in self.round_events(round_i)
                     if e[2] == JOIN)


# ---------------------------------------------------------------------------
# ChurnSchedule
# ---------------------------------------------------------------------------
class ChurnSchedule(abc.ABC):
    """Per-round liveness as a pure function of ``(round, K)``.

    Implementations MUST be deterministic in their constructor arguments
    and ``(round_i, K)`` alone (no hidden mutable state): the python and
    fused engines — and a checkpoint-resumed run — replay the identical
    membership trace. At least one slot must be live every round (a round
    with zero live participants trains nothing and has no average);
    schedules guarantee it by construction and the learner re-checks.
    """

    name: str = "churn"

    @property
    def is_static(self) -> bool:
        """True when every round is all-live, i.e. the schedule is the
        static-K paper path. The learner then bypasses the membership
        machinery entirely, so the reduction is bit-for-bit."""
        return False

    @abc.abstractmethod
    def live_mask(self, round_i: int, K: int) -> np.ndarray:
        """bool ``(K,)``: which slots are live during round ``round_i``."""


@dataclasses.dataclass(frozen=True)
class NoChurn(ChurnSchedule):
    """Every slot live every round — the paper's static-K assumption,
    spelled as a schedule. ``is_static`` keeps the learner on the exact
    pre-membership code path (bit-identical, no traced live row)."""

    name = "none"

    @property
    def is_static(self):
        return True

    def live_mask(self, round_i, K):
        return np.ones(K, bool)


def _canon_events(events):
    """Normalize scripted events to sorted ``(kind, round, slot)`` tuples
    and validate kinds/ordering per slot."""
    out = []
    for e in events:
        kind, r, k = e
        if kind not in ("crash", "rejoin"):
            raise ValueError(f"unknown scripted-churn event kind {kind!r} "
                             f"(want 'crash' or 'rejoin'): {e}")
        out.append((str(kind), int(r), int(k)))
    return tuple(sorted(out, key=lambda e: (e[1], e[2])))


@dataclasses.dataclass(frozen=True)
class ScriptedChurn(ChurnSchedule):
    """Deterministic fault-injection traces.

    ``events``: ``("crash", round, slot)`` kills the slot from that round
    on; ``("rejoin", round, slot)`` revives it from that round on (events
    apply in round order; the latest event at or before the current round
    wins per slot). ``flaky``: ``(slot, period)`` pairs — the slot is
    additionally down on every round ``r`` with ``r % period == period-1``
    (an intermittently-failing peer). ``initial_live``: number of slots
    live at round 0 (slots ``initial_live..K-1`` start dead — standby
    capacity that only a rejoin event brings up); None = all live.

    Example — slot 1 crashes in round 2 and warm-rejoins in round 4,
    while slot 3 flakes every third round::

        ScriptedChurn(events=(("crash", 2, 1), ("rejoin", 4, 1)),
                      flaky=((3, 3),))
    """

    events: tuple = ()
    flaky: tuple = ()
    initial_live: int | None = None
    name = "scripted"

    def __post_init__(self):
        object.__setattr__(self, "events", _canon_events(self.events))
        object.__setattr__(self, "flaky", tuple(
            (int(k), int(p)) for k, p in self.flaky))
        for k, p in self.flaky:
            if p < 2:
                raise ValueError(f"flaky period must be >= 2; got {p} "
                                 f"for slot {k}")

    @property
    def is_static(self):
        return (not self.events and not self.flaky
                and self.initial_live is None)

    def live_mask(self, round_i, K):
        live = np.ones(K, bool)
        if self.initial_live is not None:
            if not 1 <= self.initial_live <= K:
                raise ValueError(f"initial_live={self.initial_live} "
                                 f"outside 1..K={K}")
            live[self.initial_live:] = False
        for kind, r, k in self.events:    # sorted by round: latest wins
            if k >= K:
                raise ValueError(f"scripted event {kind, r, k} names slot "
                                 f"{k} but K={K}")
            if r <= round_i:
                live[k] = kind == "rejoin"
        for k, p in self.flaky:
            if round_i % p == p - 1:
                live[k] = False
        if not live.any():
            raise ValueError(
                f"scripted churn leaves zero live slots at round {round_i}")
        return live


@dataclasses.dataclass(frozen=True)
class RandomChurn(ChurnSchedule):
    """I.i.d. per-round churn, deterministic in ``(seed, round)``.

    Each round, every live slot fails with probability ``p_fail`` and
    every dead slot rejoins with probability ``p_join``. The transition at
    round ``r`` draws from ``SeedSequence([seed, r])``, so the full trace
    is a pure function of ``(seed, round)`` — the python and fused engines
    (and a resumed run) replay identical rounds. If a draw would kill
    every slot, the lowest-indexed live slot survives (a run must always
    have at least one live participant). ``initial_live`` slots are live
    at round 0 (None = all); round 0 itself applies no transition.
    """

    p_fail: float = 0.2
    p_join: float = 0.5
    seed: int = 0
    initial_live: int | None = None
    name = "random"

    def __post_init__(self):
        for nm, p in (("p_fail", self.p_fail), ("p_join", self.p_join)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1]; got {p}")

    @property
    def is_static(self):
        return self.p_fail == 0.0 and self.initial_live is None

    def live_mask(self, round_i, K):
        live = np.ones(K, bool)
        if self.initial_live is not None:
            if not 1 <= self.initial_live <= K:
                raise ValueError(f"initial_live={self.initial_live} "
                                 f"outside 1..K={K}")
            live[self.initial_live:] = False
        # replay transitions 1..round_i (bounded by the round counter —
        # rounds are O(10..100), and callers step sequentially anyway)
        for r in range(1, round_i + 1):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, r]))
            u = rng.random(K)
            nxt = np.where(live, u >= self.p_fail, u < self.p_join)
            if not nxt.any():
                nxt[np.argmax(live)] = True   # sole survivor, deterministic
            live = nxt
        return live


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
#: name -> factory(**kw) -> ChurnSchedule
CHURN_SCHEDULES: dict = {}


def register_churn(name, factory):
    CHURN_SCHEDULES[name] = factory
    return factory


register_churn("none", lambda **kw: NoChurn())
register_churn("scripted", ScriptedChurn)
register_churn("random", RandomChurn)


def get_churn(spec=None, **kw) -> ChurnSchedule:
    """None | registry name | ChurnSchedule instance -> ChurnSchedule."""
    if spec is None:
        return NoChurn()
    if isinstance(spec, ChurnSchedule):
        return spec
    if isinstance(spec, str):
        try:
            factory = CHURN_SCHEDULES[spec]
        except KeyError:
            raise KeyError(f"unknown churn schedule {spec!r}; registered: "
                           f"{sorted(CHURN_SCHEDULES)}") from None
        return factory(**kw)
    raise TypeError("churn must be None, a registry name, or a "
                    f"ChurnSchedule; got {spec!r}")
