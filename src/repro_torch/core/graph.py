"""Undirected graph in CSR form, numpy-backed.

The partitioner is a host-side sequential heuristic (control plane), so the
graph lives in numpy.  Edges are stored once with a canonical id; the CSR
adjacency stores each edge twice (u->v and v->u) but both directions carry
the same edge id, so edge-set membership is a single bitmap over E ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable CSR graph.

    Attributes:
      indptr:   (V+1,) int64 — CSR row pointers.
      indices:  (2E,)  int32 — neighbor vertex ids.
      edge_ids: (2E,)  int32 — canonical edge id for each adjacency slot;
                the two directions of one undirected edge share an id.
      edges:    (E, 2) int32 — canonical (u, v) with u < v.
    """

    indptr: np.ndarray
    indices: np.ndarray
    edge_ids: np.ndarray
    edges: np.ndarray

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def degree(self, u=None):
        deg = np.diff(self.indptr)
        return deg if u is None else deg[u]

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def incident_edge_ids(self, u: int) -> np.ndarray:
        return self.edge_ids[self.indptr[u]:self.indptr[u + 1]]

    @property
    def avg_degree(self) -> float:
        return 2.0 * self.num_edges / max(1, self.num_vertices)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Graph(V={self.num_vertices}, E={self.num_edges}, "
                f"maxdeg={int(self.degree().max(initial=0))})")


def from_edge_list(edges: np.ndarray, num_vertices: int | None = None) -> Graph:
    """Build a Graph from an (N, 2) array of (possibly duplicated) edges.

    Self loops are dropped; duplicate/reverse duplicates are merged.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    # Canonicalize: u < v, drop self loops.
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    if num_vertices is None:
        num_vertices = int(max(u.max(initial=-1), v.max(initial=-1)) + 1)
    # Dedup via single key.
    key = u * np.int64(num_vertices) + v
    _, first = np.unique(key, return_index=True)
    u, v = u[first], v[first]
    E = len(u)
    eid = np.arange(E, dtype=np.int32)

    # Symmetric adjacency: (u->v, eid) and (v->u, eid).
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u]).astype(np.int32)
    eids = np.concatenate([eid, eid])
    order = np.argsort(src, kind="stable")
    src, dst, eids = src[order], dst[order], eids[order]
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    edges_canon = np.stack([u, v], axis=1).astype(np.int32)
    return Graph(indptr=indptr, indices=dst, edge_ids=eids, edges=edges_canon)


def subgraph_edge_mask(g: Graph, edge_mask: np.ndarray) -> Graph:
    """Graph induced by the edges where edge_mask is True (vertex ids kept)."""
    return from_edge_list(g.edges[edge_mask], num_vertices=g.num_vertices)


# ---------------------------------------------------------------------------
# growable graph (the dynamic-stream substrate)
# ---------------------------------------------------------------------------

#: edge-key packing: canonical (u, v) with u < v fits one int64 because
#: vertex ids are int32 — independent of |V|, so keys survive vertex growth
_KEY_SHIFT = np.int64(32)


def edge_keys(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(k,) int64 canonical-pair keys, stable under vertex-count growth."""
    return (np.asarray(u, dtype=np.int64) << _KEY_SHIFT) \
        | np.asarray(v, dtype=np.int64)


class GrowableGraph:
    """A :class:`Graph` that accepts amortized-O(1) edge/vertex appends.

    Presents the read surface the partition layer uses (``edges``,
    ``num_vertices``, ``num_edges``, ``degree``, CSR ``indptr`` /
    ``indices`` / ``edge_ids``); mutation is :meth:`append` only —
    canonical ids are stable forever, so every (p, E) / (p, V) structure
    keyed on them stays valid across growth.  The edge array grows by
    capacity doubling; the CSR adjacency is invalidated on append and
    rebuilt lazily on first access (expansion-side consumers only — the
    dynamic hot path never touches it).

    Edge *identity* is tracked in an id index (``eids_of``): the dynamic
    layer uses it to reuse the canonical id when a previously-deleted
    edge is re-inserted, so an id means one (u, v) pair for the lifetime
    of the graph.
    """

    def __init__(self, edges: np.ndarray, num_vertices: int):
        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        n = len(edges)
        self._edges = np.empty((max(16, 2 * n), 2), dtype=np.int32)
        self._edges[:n] = edges
        self._n = n
        self._num_vertices = int(num_vertices)
        self._deg = np.zeros(max(16, 2 * self._num_vertices), dtype=np.int64)
        np.add.at(self._deg[:self._num_vertices], edges.ravel(), 1)
        self._key_index = {int(k): i for i, k in
                           enumerate(edge_keys(edges[:, 0], edges[:, 1]))}
        self._csr: Graph | None = None

    @classmethod
    def from_graph(cls, g: "Graph | GrowableGraph") -> "GrowableGraph":
        if isinstance(g, cls):
            return g
        return cls(g.edges, g.num_vertices)

    # -- Graph read surface --------------------------------------------------
    @property
    def edges(self) -> np.ndarray:
        return self._edges[:self._n]

    @property
    def num_vertices(self) -> int:
        return self._num_vertices

    @property
    def num_edges(self) -> int:
        return self._n

    def degree(self, u=None):
        deg = self._deg[:self._num_vertices]
        return deg if u is None else deg[u]

    @property
    def avg_degree(self) -> float:
        return 2.0 * self._n / max(1, self._num_vertices)

    def _rebuild_csr(self) -> Graph:
        if self._csr is None or self._csr.num_edges != self._n:
            self._csr = from_edge_list(self.edges,
                                       num_vertices=self._num_vertices)
        return self._csr

    @property
    def indptr(self) -> np.ndarray:
        return self._rebuild_csr().indptr

    @property
    def indices(self) -> np.ndarray:
        return self._rebuild_csr().indices

    @property
    def edge_ids(self) -> np.ndarray:
        return self._rebuild_csr().edge_ids

    def neighbors(self, u: int) -> np.ndarray:
        return self._rebuild_csr().neighbors(u)

    def incident_edge_ids(self, u: int) -> np.ndarray:
        return self._rebuild_csr().incident_edge_ids(u)

    # -- identity / mutation -------------------------------------------------
    def eids_of(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """(k,) int64 canonical edge id per (already canonical) pair, -1
        where the pair was never appended."""
        idx = self._key_index
        return np.fromiter(
            (idx.get(int(k), -1) for k in edge_keys(u, v)),
            dtype=np.int64, count=len(u))

    def append(self, uv: np.ndarray) -> np.ndarray:
        """Append genuinely-new canonical (u < v) pairs; returns their new
        edge ids.  Pairs must be canonical, loop-free, unique within the
        batch, and absent from the graph (``ValueError`` otherwise) — the
        caller (``PartitionState.append_edges``) enforces all four, this
        re-checks the cheap ones."""
        uv = np.asarray(uv, dtype=np.int64).reshape(-1, 2)
        if len(uv) == 0:
            return np.empty(0, dtype=np.int64)
        if (uv[:, 0] >= uv[:, 1]).any():
            raise ValueError("append needs canonical loop-free pairs "
                             "(u < v)")
        keys = edge_keys(uv[:, 0], uv[:, 1])
        if len(np.unique(keys)) != len(keys):
            raise ValueError("append batch contains duplicate pairs")
        idx = self._key_index
        for j, key in enumerate(keys):       # validate before any mutation
            if int(key) in idx:
                raise ValueError(
                    f"edge ({uv[j, 0]}, {uv[j, 1]}) already present "
                    f"(id {idx[int(key)]}); re-place it instead of "
                    f"appending")
        n, k = self._n, len(uv)
        if n + k > len(self._edges):
            grown = np.empty((max(2 * len(self._edges), n + k), 2),
                             dtype=np.int32)
            grown[:n] = self._edges[:n]
            self._edges = grown
        self._edges[n:n + k] = uv
        for j, key in enumerate(keys):
            idx[int(key)] = n + j
        self._n = n + k
        nv = int(uv.max()) + 1
        if nv > self._num_vertices:
            self._num_vertices = nv
        if nv > len(self._deg):
            grown_deg = np.zeros(max(2 * len(self._deg), nv), dtype=np.int64)
            grown_deg[:len(self._deg)] = self._deg
            self._deg = grown_deg
        np.add.at(self._deg, uv.ravel(), 1)
        self._csr = None
        return np.arange(n, n + k, dtype=np.int64)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"GrowableGraph(V={self.num_vertices}, E={self.num_edges})")
