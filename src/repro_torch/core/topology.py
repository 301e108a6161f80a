"""Communication topologies for decentralized gossip (who talks to whom),
ported from ``repro/core/topology.py`` (numpy only; the port keeps its
own copy, and its matrices equal the JAX package's bit for bit).

The paper's Eq. 2 is all-to-all averaging, but a multi-datacenter WAN is a
sparse graph: CDSGD (Jiang et al., 1706.07880) runs consensus SGD over any
fixed connected topology through a doubly-stochastic mixing matrix, and
D² (Tang et al., 1803.07068) corrects the variance so decentralized
non-IID shards still converge. ``api.GraphGossip(topology)`` /
``api.D2Gossip(topology)`` consume these objects:

  * ``Topology.adjacency(round, K)`` — bool (K, K), ``A[k, j]`` = "k
    receives from j" (symmetric for undirected graphs);
  * ``Topology.mixing_matrix(round, K, live=)`` — the row-stochastic
    (doubly stochastic when all-live) mixing weights. Undirected graphs
    get Metropolis–Hastings weights; directed circulants (ring, one-peer
    exponential) use W = (I + P)/2. Liveness restricts to the live
    subgraph: dead rows become identity carries, a sole survivor keeps
    its own model, and when churn disconnects the live subgraph the
    mixing proceeds component-wise (block-diagonal) with a warning;
  * ``Topology.offsets`` / ``edge_perms`` — the neighbor-offset list for
    circulant graphs and its decomposition of the directed edge set into
    whole permutations (the pod path's one point-to-point exchange per
    permutation; that path is still to port, ROADMAP.md);
  * ``Topology.spectral_gap(K)`` — ``1 - |λ₂|`` of the (period-averaged,
    for time-varying graphs) mixing matrix;
  * ``Topology.validate(K)`` — the connectivity guard: BFS over the
    union graph of one period, rejecting disconnected topologies at
    learner construction.

Topologies may be time-varying (``adjacency(round, K)`` depends on the
round): the fused engine reads the per-round matrix from one static
device buffer, so a graph change never captures again.

Registry: ``ring`` (directed cycle — the ``RingGossip`` graph),
``grid2d``/``torus`` (2-D torus), ``hypercube`` (K a power of two),
``exponential`` (time-varying one-peer exponential graph),
``erdos_renyi(p, seed)`` (deterministic G(K, p) sample), ``complete``
(MH weights reduce to Eq. 2's uniform 1/K matrix). Resolve with
``get_topology(name | Topology | None)``.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import warnings

import numpy as np

__all__ = [
    "Topology", "RingTopology", "Grid2DTopology", "HypercubeTopology",
    "ExponentialTopology", "ErdosRenyiTopology", "CompleteTopology",
    "TOPOLOGIES", "register_topology", "get_topology",
    "metropolis_weights", "component_labels", "is_connected",
]


# ---------------------------------------------------------------------------
# Graph helpers (host-side numpy — matrices are built once per
# (round-key, K, live-set) and cached by the aggregator)
# ---------------------------------------------------------------------------
def component_labels(adj) -> np.ndarray:
    """Connected-component label per node over the UNDIRECTED support of
    ``adj`` (labels are 0..n_components-1 in first-seen order)."""
    A = np.asarray(adj, bool)
    K = A.shape[0]
    und = A | A.T
    labels = np.full(K, -1, np.int64)
    n = 0
    for s in range(K):
        if labels[s] >= 0:
            continue
        stack = [s]
        labels[s] = n
        while stack:
            u = stack.pop()
            for v in np.nonzero(und[u])[0]:
                if labels[v] < 0:
                    labels[v] = n
                    stack.append(int(v))
        n += 1
    return labels


def is_connected(adj) -> bool:
    """True when every node reaches every other over the undirected
    support of ``adj`` (K <= 1 is trivially connected)."""
    A = np.asarray(adj, bool)
    if A.shape[0] <= 1:
        return True
    return int(component_labels(A).max()) == 0


def metropolis_weights(adj) -> np.ndarray:
    """Metropolis–Hastings mixing weights for an undirected graph:
    ``W[k, j] = 1 / (1 + max(deg_k, deg_j))`` on edges, diagonal takes the
    remainder. Symmetric and doubly stochastic for ANY degree profile —
    isolated nodes (and every node of a dead/live-masked row) get an
    identity row, so the same formula serves the live-subgraph case."""
    A = np.asarray(adj, bool).copy()
    np.fill_diagonal(A, False)
    K = A.shape[0]
    deg = A.sum(1)
    W = np.zeros((K, K), np.float64)
    ii, jj = np.nonzero(A)
    W[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    np.fill_diagonal(W, 1.0 - W.sum(1))
    return W.astype(np.float32)


def _check_live(live, K, name, round_index):
    live = np.asarray(live, bool)
    if live.shape != (K,):
        raise ValueError(f"live mask must have shape ({K},); got "
                         f"{live.shape}")
    if not live.any():
        raise ValueError(f"{name} gossip has zero live participants at "
                         f"round {round_index}")
    return live


# ---------------------------------------------------------------------------
# The Topology protocol
# ---------------------------------------------------------------------------
class Topology(abc.ABC):
    """A communication graph over K participants (possibly per-round).

    Subclasses implement ``adjacency``; the base class derives MH mixing
    weights, liveness handling (live-subgraph renormalization with a
    component-wise fallback), the circulant neighbor-offset list and its
    permutation decomposition for the sparse pod path, the spectral-gap
    diagnostic, and the construction-time connectivity guard. Directed
    topologies (``symmetric = False``) override ``mixing_matrix``.
    """

    name: str = "topology"
    #: True when ``adjacency(round, K)`` depends on the round; the graph
    #: repeats with period ``period(K)``.
    time_varying: bool = False
    #: True when the adjacency (and hence the MH matrix) is symmetric.
    symmetric: bool = True
    #: appended to the connectivity-guard error (e.g. a reseed hint).
    _disconnected_hint: str = ""

    @abc.abstractmethod
    def adjacency(self, round_index: int, K: int) -> np.ndarray:
        """Bool (K, K) adjacency for this round; ``A[k, j]`` means k
        RECEIVES from j. No self loops."""

    def period(self, K: int) -> int:
        """Number of rounds after which a time-varying graph repeats
        (1 for static graphs)."""
        return 1

    def union_adjacency(self, K: int) -> np.ndarray:
        """OR of the adjacency over one period — the graph whose
        connectivity decides whether consensus can ever be reached."""
        A = np.zeros((K, K), bool)
        for t in range(self.period(K)):
            A |= self.adjacency(t, K)
        return A

    def validate(self, K: int) -> "Topology":
        """Connectivity guard: reject a disconnected topology outright
        (BFS over the period-union graph). Called by ``CoLearner`` at
        construction via ``Aggregator.validate``."""
        if K < 1:
            raise ValueError(f"topology {self.name!r} needs K >= 1; "
                             f"got K={K}")
        if not is_connected(self.union_adjacency(K)):
            raise ValueError(
                f"topology {self.name!r} is disconnected at K={K}: gossip "
                f"over it can never reach consensus"
                f"{self._disconnected_hint}")
        return self

    def degree(self, round_index: int, K: int) -> int:
        """Max in-degree of this round's graph (the O(degree) comm
        factor)."""
        if K <= 1:
            return 0
        return int(self.adjacency(round_index, K).sum(1).max())

    def mixing_matrix(self, round_index: int, K: int,
                      live=None) -> np.ndarray:
        """Row-stochastic (K, K) f32 mixing weights for this round.

        All-live: Metropolis–Hastings on the round's graph — symmetric
        and doubly stochastic. ``live`` (elastic membership): MH on the
        LIVE SUBGRAPH (edges between live nodes only) — dead rows and
        isolated live nodes degrade to identity (sole survivor keeps its
        own model), and a live subgraph churn has split into components
        mixes block-diagonally (component-wise, never across), with a
        warning logged."""
        adj = self.adjacency(round_index, K)
        if live is None:
            return metropolis_weights(adj)
        live = _check_live(live, K, self.name, round_index)
        sub = adj & live[:, None] & live[None, :]
        self._warn_if_split(sub, live, round_index)
        return metropolis_weights(sub)

    def _warn_if_split(self, sub, live, round_index):
        idx = np.nonzero(live)[0]
        if len(idx) > 1:
            labels = component_labels(sub)
            if len(set(labels[idx])) > 1:
                warnings.warn(
                    f"churn disconnected the {self.name!r} gossip graph at "
                    f"round {round_index} (live={live.astype(int)}): "
                    f"mixing proceeds component-wise until peers rejoin",
                    RuntimeWarning, stacklevel=3)

    def offsets(self, round_index: int, K: int):
        """The neighbor-offset list when this round's graph is circulant
        (``A[k, (k + d) % K]`` for every k): a tuple of receive-offsets
        d, else None. The ring is ``(K - 1,)`` (receive from the
        predecessor), the static exponential graph ``(1, 2, 4, ...)``."""
        A = self.adjacency(round_index, K)
        k = np.arange(K)
        ds = []
        for d in range(1, K):
            col = A[k, (k + d) % K]
            if col.all():
                ds.append(d)
            elif col.any():
                return None
        return tuple(ds)

    def edge_perms(self, round_index: int, K: int):
        """Decompose this round's directed edge set into whole
        permutations of {0..K-1} — each a tuple of ``(src, dst)`` pairs,
        one point-to-point exchange each on the pod path. None when the
        graph admits no such decomposition (irregular graphs fall back
        to the dense traced mixing). Default: circulant offsets."""
        ds = self.offsets(round_index, K)
        if ds is None or K <= 1:
            return None
        # k receives from (k + d) % K, so source j sends to (j - d) % K
        return tuple(tuple((j, (j - d) % K) for j in range(K)) for d in ds)

    def in_neighbors(self, round_index: int, K: int):
        """Tuple (per node) of tuples of in-neighbor indices — the
        host-side "who do I receive from" view for diagnostics."""
        A = self.adjacency(round_index, K)
        return tuple(tuple(int(j) for j in np.nonzero(A[k])[0])
                     for k in range(K))

    def spectral_gap(self, K: int, round_index=None) -> float:
        """``1 - |λ₂|`` of the mixing matrix — the consensus
        contraction-rate diagnostic (0: disconnected / no mixing; 1:
        one-shot consensus, e.g. ``complete``). ``round_index=None``
        uses the period-AVERAGED matrix, since a single one-peer round
        of a time-varying graph is not connected on its own."""
        if K <= 1:
            return 1.0
        if round_index is None:
            W = np.mean([np.asarray(self.mixing_matrix(t, K), np.float64)
                         for t in range(self.period(K))], axis=0)
        else:
            W = np.asarray(self.mixing_matrix(round_index, K), np.float64)
        ev = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
        return float(1.0 - ev[1])


def _directed_pair_matrix(K, peer_of, live, name, round_index):
    """W = (I + P)/2 for a directed one-in-neighbor graph given
    ``peer_of[k]`` (k's in-neighbor, or k itself for "no peer"). Under
    liveness a live row whose peer is dead keeps its own model this
    round; dead rows are identity carries."""
    W = np.zeros((K, K), np.float32)
    if live is None:
        for k in range(K):
            W[k, k] += 0.5
            W[k, peer_of(k)] += 0.5
        return W
    live = _check_live(live, K, name, round_index)
    for k in range(K):
        p = peer_of(k)
        if not live[k] or p == k or not live[p]:
            W[k, k] = 1.0
        else:
            W[k, k] += 0.5
            W[k, p] += 0.5
    return W


# ---------------------------------------------------------------------------
# Concrete topologies
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RingTopology(Topology):
    """Directed cycle — the legacy ``RingGossip`` graph: participant k
    receives its ring predecessor's model, ``W = (I + P)/2`` (doubly
    stochastic, not symmetric). Liveness ROUTES to the nearest live
    predecessor (the graph heals around dead nodes instead of dropping
    their edges), matching the legacy matrix bit-for-bit."""

    name = "ring"
    symmetric = False

    def adjacency(self, round_index, K):
        A = np.zeros((K, K), bool)
        if K > 1:
            k = np.arange(K)
            A[k, (k - 1) % K] = True
        return A

    def mixing_matrix(self, round_index, K, live=None):
        if live is None:
            W = np.zeros((K, K), np.float32)
            for k in range(K):
                W[k, k] += 0.5
                W[k, (k - 1) % K] += 0.5
            return W
        # elastic membership: route around dead neighbors — each live
        # participant averages with its nearest LIVE ring predecessor; a
        # sole survivor (or a dead row, which the engine identity-carries
        # anyway) keeps its own model
        live = np.asarray(live, bool)
        if not live.any():
            raise ValueError(
                f"ring gossip has zero live participants at round "
                f"{round_index}")
        W = np.zeros((K, K), np.float32)
        for k in range(K):
            if not live[k]:
                W[k, k] = 1.0
                continue
            prev = (k - 1) % K
            while prev != k and not live[prev]:
                prev = (prev - 1) % K
            if prev == k:                       # sole live participant
                W[k, k] = 1.0
            else:
                W[k, k] += 0.5
                W[k, prev] += 0.5
        return W


@dataclasses.dataclass(frozen=True)
class Grid2DTopology(Topology):
    """2-D torus: K factors into the most-square R x C grid and each node
    links to its four wrap-around neighbors (fewer when an axis has
    length <= 2 — coincident neighbors collapse to one edge). A prime K
    degenerates to the undirected cycle (R=1)."""

    name = "grid2d"

    @staticmethod
    def shape(K):
        r = int(math.isqrt(K))
        while K % r:
            r -= 1
        return r, K // r

    def adjacency(self, round_index, K):
        R, C = self.shape(K)
        A = np.zeros((K, K), bool)
        for k in range(K):
            r, c = divmod(k, C)
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                n = (rr % R) * C + (cc % C)
                if n != k:
                    A[k, n] = A[n, k] = True
        return A

    def edge_perms(self, round_index, K):
        R, C = self.shape(K)
        out, seen = [], set()
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            pairs, ok = [], True
            for k in range(K):
                r, c = divmod(k, C)
                src = ((r + dr) % R) * C + ((c + dc) % C)
                if src == k:                    # axis of length 1: no move
                    ok = False
                    break
                pairs.append((src, k))
            if not ok:
                continue
            key = tuple(sorted(pairs))
            if key in seen:                     # axis of length 2: the two
                continue                        # shifts are the same edge
            seen.add(key)
            out.append(tuple(pairs))
        return tuple(out) or None


@dataclasses.dataclass(frozen=True)
class HypercubeTopology(Topology):
    """log2(K)-dimensional hypercube (K must be a power of two): node k
    links to ``k XOR 2^i`` per dimension — diameter log2(K), degree
    log2(K)."""

    name = "hypercube"

    @staticmethod
    def _dims(K):
        if K < 1 or K & (K - 1):
            raise ValueError(
                f"hypercube topology needs K a power of two; got K={K}")
        return K.bit_length() - 1

    def adjacency(self, round_index, K):
        dims = self._dims(K)
        A = np.zeros((K, K), bool)
        for i in range(dims):
            k = np.arange(K)
            A[k, k ^ (1 << i)] = True
        return A

    def edge_perms(self, round_index, K):
        dims = self._dims(K)
        if dims == 0:
            return None
        return tuple(tuple((j ^ (1 << i), j) for j in range(K))
                     for i in range(dims))


@dataclasses.dataclass(frozen=True)
class ExponentialTopology(Topology):
    """Time-varying one-peer exponential graph (Assran et al.,
    1811.10792): at round t every participant receives from the peer
    ``2^(t mod ceil(log2 K))`` slots behind it, ``W_t = (I + P_d)/2`` —
    O(1) wire traffic per node per round, and the UNION over one period
    is the exponential graph, so consensus contracts at near-complete
    rate per period. The per-round matrix rides into the executables as
    traced data: the changing graph never recompiles."""

    name = "exponential"
    time_varying = True
    symmetric = False

    def period(self, K):
        return max(1, (max(K, 1) - 1).bit_length())

    def _offset(self, round_index, K):
        if K <= 1:
            return 0
        return (1 << (round_index % self.period(K))) % K

    def adjacency(self, round_index, K):
        A = np.zeros((K, K), bool)
        d = self._offset(round_index, K)
        if d:
            k = np.arange(K)
            A[k, (k - d) % K] = True
        return A

    def mixing_matrix(self, round_index, K, live=None):
        d = self._offset(round_index, K)
        return _directed_pair_matrix(
            K, lambda k: (k - d) % K if d else k, live, self.name,
            round_index)


@dataclasses.dataclass(frozen=True)
class ErdosRenyiTopology(Topology):
    """Deterministic G(K, p) sample: each undirected edge is present with
    probability ``p``, drawn from ``SeedSequence([seed, K])`` so the
    graph is a pure function of (p, seed, K). The connectivity guard
    rejects unlucky draws at construction — reseed or raise p."""

    p: float = 0.5
    seed: int = 0
    name = "erdos_renyi"
    _disconnected_hint = " (try a different seed or a larger p)"

    def adjacency(self, round_index, K):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"erdos_renyi needs 0 <= p <= 1; got "
                             f"p={self.p}")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, K]))
        U = np.triu(rng.random((K, K)) < self.p, 1)
        return U | U.T


@dataclasses.dataclass(frozen=True)
class CompleteTopology(Topology):
    """All-to-all: MH weights reduce to the uniform 1/K matrix — Eq. 2 as
    a (degenerate, O(K)-comm) member of the topology family, kept for
    sanity baselines."""

    name = "complete"

    def adjacency(self, round_index, K):
        A = np.ones((K, K), bool)
        np.fill_diagonal(A, False)
        return A


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
#: name -> factory(**kw) -> Topology (erdos_renyi takes p=/seed=).
TOPOLOGIES: dict = {}


def register_topology(name, factory):
    TOPOLOGIES[name] = factory
    return factory


register_topology("ring", RingTopology)
register_topology("grid2d", Grid2DTopology)
register_topology("torus", Grid2DTopology)              # alias
register_topology("hypercube", HypercubeTopology)
register_topology("exponential", ExponentialTopology)
register_topology("erdos_renyi",
                  lambda p=0.5, seed=0: ErdosRenyiTopology(p=p, seed=seed))
register_topology("er", TOPOLOGIES["erdos_renyi"])      # alias
register_topology("complete", CompleteTopology)


def get_topology(spec=None, **kw) -> Topology:
    """None | registry name | Topology instance -> Topology (None is the
    ring, the legacy gossip default). ``erdos_renyi`` accepts ``p=`` and
    ``seed=``."""
    if spec is None:
        return RingTopology()
    if isinstance(spec, Topology):
        return spec
    if isinstance(spec, str):
        try:
            factory = TOPOLOGIES[spec]
        except KeyError:
            raise KeyError(f"unknown topology {spec!r}; registered: "
                           f"{sorted(TOPOLOGIES)}") from None
        return factory(**kw)
    raise TypeError(f"topology must be None, a registry name, or a "
                    f"Topology; got {spec!r}")
