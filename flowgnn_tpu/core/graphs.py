"""Graph containers: single graphs, host-side transforms, packed static batches.

The reference streams one variable-size graph at a time through a dataflow
pipeline (GIN/src/GIN_compute.cc:44-98). An accelerator wants the opposite:
many small graphs packed into one statically-shaped batch so that every op
(gather, segment-sum, update matmul) is a large dense array op. `PackedGraphs` is that
container — the jraph-style flat packing:

  * all nodes of all graphs concatenated into one axis of capacity
    ``node_capacity`` (plus one trailing pad node),
  * all edges concatenated with *global* node indices, padded edges pointing
    at the pad node,
  * per-graph counts (``n_node``/``n_edge``) and a per-node graph id for
    segment readout.

Everything is a static shape, so one jit covers the whole dataset stream.

Host-side graph transforms mirror the reference's host-side augmentations:
  * ``add_virtual_node`` ≙ GIN-VN/src/host_load.cc:129-153 (one extra
    zero-feature node + a bidirectional star of zero-attr edges),
  * ``add_self_loops`` ≙ GAT/src/load_inputs.cc:144-149 (device-side there,
    host-side transform here — same math),
  * ``laplacian_eigenvectors`` ≙ the precomputed DGN ``eig/g%d.txt`` files
    (DGN/src/host_load.cc:154-216).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from .features import NUM_ATOM_FEATURES, NUM_BOND_FEATURES


@dataclasses.dataclass
class Graph:
    """One graph in host memory (reference on-disk unit: g%d_*.bin)."""

    node_feat: np.ndarray  # [num_nodes, 9] int32 categorical atom features
    edge_index: np.ndarray  # [num_edges, 2] int32 (u, v) = (source, dest)
    edge_attr: Optional[np.ndarray] = None  # [num_edges, 3] int32 bond features
    node_eigen: Optional[np.ndarray] = None  # [num_nodes, 4] float32 (DGN)
    node_vn: Optional[np.ndarray] = None  # [num_nodes] bool — analytic-VN marker

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[0])

    def validate(self) -> "Graph":
        assert self.node_feat.ndim == 2 and self.node_feat.shape[1] == NUM_ATOM_FEATURES
        assert self.edge_index.ndim == 2 and self.edge_index.shape[1] == 2
        if self.num_edges:
            assert self.edge_index.min() >= 0
            assert self.edge_index.max() < self.num_nodes
        if self.edge_attr is not None:
            assert self.edge_attr.shape == (self.num_edges, NUM_BOND_FEATURES)
        if self.node_eigen is not None:
            assert self.node_eigen.shape[0] == self.num_nodes
        return self


# ---------------------------------------------------------------------------
# Host-side graph transforms
# ---------------------------------------------------------------------------


def add_virtual_node(g: Graph) -> Graph:
    """GIN-VN augmentation: append one zero-feature node connected to all.

    Mirrors GIN-VN/src/host_load.cc:129,137-141,149-153: the virtual node gets
    feature vector 0, and for every original node ``nd`` two zero-attr edges
    ``(nd, N)`` and ``(N, nd)`` are appended after the original edges.
    """
    n = g.num_nodes
    node_feat = np.concatenate(
        [g.node_feat, np.zeros((1, g.node_feat.shape[1]), dtype=g.node_feat.dtype)]
    )
    star = np.empty((2 * n, 2), dtype=g.edge_index.dtype)
    star[0::2, 0] = np.arange(n)
    star[0::2, 1] = n
    star[1::2, 0] = n
    star[1::2, 1] = np.arange(n)
    edge_index = np.concatenate([g.edge_index, star])
    edge_attr = None
    if g.edge_attr is not None:
        edge_attr = np.concatenate(
            [g.edge_attr, np.zeros((2 * n, g.edge_attr.shape[1]), g.edge_attr.dtype)]
        )
    return Graph(node_feat, edge_index, edge_attr, g.node_eigen)


def add_virtual_node_analytic(g: Graph) -> Graph:
    """GIN-VN augmentation, star edges kept ALGEBRAIC instead of material.

    Same math as ``add_virtual_node`` (GIN-VN/src/host_load.cc:129-153) — the
    virtual node participates in the node MLP and the mean pool exactly like
    a real node — but the 2N zero-attr star edges are NOT appended. Because
    every star edge carries the same constant edge embedding e0 (bond attr
    (0,0,0)), the star's messages factor into two per-graph dense ops:

      m[vn]      = Σ_{real v} relu(h_v + e0)   (a per-graph pooled sum)
      m[real v] += relu(h_vn + e0)             (a per-graph broadcast)

    which models/gin.py computes with a per-graph segment-sum instead of
    scattering 2N edges — the VN hub is the one in-degree that grows with
    graph size. The appended node is flagged in ``node_vn`` and the
    flag rides the packed batch; models/gin.py dispatches on it.
    """
    n = g.num_nodes
    node_feat = np.concatenate(
        [g.node_feat, np.zeros((1, g.node_feat.shape[1]), dtype=g.node_feat.dtype)]
    )
    vn = np.zeros(n + 1, dtype=bool)
    vn[n] = True
    old_vn = g.node_vn if g.node_vn is not None else np.zeros(n, bool)
    vn[:n] = old_vn
    return Graph(node_feat, g.edge_index, g.edge_attr, g.node_eigen, vn)


def add_self_loops(g: Graph) -> Graph:
    """Prepend one self edge per node (GAT seeds each node's in-list with it).

    The reference inserts the self edge *first* in each destination's gather
    list (GAT/src/load_inputs.cc:144-149); order only matters for fixed-point
    accumulation, but we keep the same convention (self edges first).
    """
    loops = np.stack([np.arange(g.num_nodes)] * 2, axis=1).astype(g.edge_index.dtype)
    edge_index = np.concatenate([loops, g.edge_index])
    edge_attr = None
    if g.edge_attr is not None:
        edge_attr = np.concatenate(
            [
                np.zeros((g.num_nodes, g.edge_attr.shape[1]), g.edge_attr.dtype),
                g.edge_attr,
            ]
        )
    return Graph(g.node_feat, edge_index, edge_attr, g.node_eigen, g.node_vn)


def laplacian_eigenvectors(g: Graph, k: int = 4) -> Graph:
    """Attach the first ``k`` symmetric-normalized Laplacian eigenvectors.

    The reference ships these precomputed per graph (DGN ``eig/g%d.txt``,
    loaded by DGN/src/host_load.cc:154-216); only component [1] (the Fiedler
    vector) is consumed on device (DGN/src/load_inputs.cc:105-110). Sign and
    ordering of eigenvectors are not unique; when validating against reference
    files, consume the committed values instead. Our convention: ascending
    eigenvalues, dense ``eigh`` on L_sym = I - D^-1/2 A D^-1/2.
    """
    n = g.num_nodes
    a = np.zeros((n, n), dtype=np.float64)
    if g.num_edges:
        a[g.edge_index[:, 0], g.edge_index[:, 1]] = 1.0
    a = np.maximum(a, a.T)
    deg = a.sum(axis=1)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    lap = np.eye(n) - dinv[:, None] * a * dinv[None, :]
    _, vecs = np.linalg.eigh(lap)
    eig = np.zeros((n, k), dtype=np.float32)
    eig[:, : min(k, n)] = vecs[:, : min(k, n)]
    return Graph(g.node_feat, g.edge_index, g.edge_attr, eig, g.node_vn)


# ---------------------------------------------------------------------------
# Packed static-shape batches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedGraphs:
    """A fixed-capacity flat batch of graphs (all arrays statically shaped).

    Index convention: nodes of graph i occupy a contiguous range; the very
    last node slot (index ``node_capacity``) is the designated *pad node* that
    all padded edges point at, so gathers/scatters stay in bounds and padding
    contributions land in a slot nothing reads. ``graph_capacity`` likewise
    includes one trailing pad graph that owns all pad nodes.
    """

    node_feat: np.ndarray  # [N+1, 9] int32
    node_graph: np.ndarray  # [N+1]   int32 graph id (pad nodes → G)
    senders: np.ndarray  # [E]     int32 global u (pad edges → N)
    receivers: np.ndarray  # [E]     int32 global v (pad edges → N)
    edge_attr: np.ndarray  # [E, 3]  int32 (zeros when model has none)
    n_node: np.ndarray  # [G+1]   int32 per-graph node counts (pad graph last)
    n_edge: np.ndarray  # [G+1]   int32
    node_eigen: Optional[np.ndarray] = None  # [N+1, 4] float32
    node_vn: Optional[np.ndarray] = None  # [N+1] bool — analytic virtual nodes

    @property
    def node_capacity(self) -> int:
        return int(self.node_feat.shape[0]) - 1

    @property
    def edge_capacity(self) -> int:
        return int(self.senders.shape[0])

    @property
    def graph_capacity(self) -> int:
        return int(self.n_node.shape[0]) - 1

    @property
    def num_graphs(self) -> int:
        """Number of real (non-pad) graphs."""
        return int(np.sum(self.n_node[:-1] > 0))


def pack_graphs(
    graphs: Sequence[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
    with_eigen: bool = False,
) -> PackedGraphs:
    """Pack ``graphs`` into one static-shape batch. Raises if capacity exceeded."""
    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    if total_nodes > node_capacity:
        raise ValueError(f"node capacity {node_capacity} < {total_nodes}")
    if total_edges > edge_capacity:
        raise ValueError(f"edge capacity {edge_capacity} < {total_edges}")
    if len(graphs) > graph_capacity:
        raise ValueError(f"graph capacity {graph_capacity} < {len(graphs)}")

    node_feat = np.zeros((node_capacity + 1, NUM_ATOM_FEATURES), np.int32)
    node_graph = np.full(node_capacity + 1, graph_capacity, np.int32)
    senders = np.full(edge_capacity, node_capacity, np.int32)
    receivers = np.full(edge_capacity, node_capacity, np.int32)
    edge_attr = np.zeros((edge_capacity, NUM_BOND_FEATURES), np.int32)
    n_node = np.zeros(graph_capacity + 1, np.int32)
    n_edge = np.zeros(graph_capacity + 1, np.int32)
    node_eigen = np.zeros((node_capacity + 1, 4), np.float32) if with_eigen else None
    with_vn = any(g.node_vn is not None for g in graphs)
    node_vn = np.zeros(node_capacity + 1, bool) if with_vn else None

    node_off = 0
    edge_off = 0
    for i, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        node_feat[node_off : node_off + n] = g.node_feat
        node_graph[node_off : node_off + n] = i
        if with_vn and g.node_vn is not None:
            node_vn[node_off : node_off + n] = g.node_vn
        senders[edge_off : edge_off + e] = g.edge_index[:, 0] + node_off
        receivers[edge_off : edge_off + e] = g.edge_index[:, 1] + node_off
        if g.edge_attr is not None:
            edge_attr[edge_off : edge_off + e] = g.edge_attr
        if with_eigen:
            if g.node_eigen is None:
                raise ValueError("with_eigen=True but graph has no node_eigen")
            k = min(4, g.node_eigen.shape[1])
            node_eigen[node_off : node_off + n, :k] = g.node_eigen[:, :k]
        n_node[i] = n
        n_edge[i] = e
        node_off += n
        edge_off += e

    # Pad nodes belong to the trailing pad graph; give it their count so that
    # segment readout over graph ids never divides by zero unexpectedly.
    n_node[graph_capacity] = node_capacity + 1 - node_off
    n_edge[graph_capacity] = edge_capacity - edge_off
    return PackedGraphs(
        node_feat, node_graph, senders, receivers, edge_attr, n_node, n_edge,
        node_eigen, node_vn,
    )


def auto_edge_capacity(graphs: Sequence[Graph], node_capacity: int) -> int:
    """Edge capacity sized so ``node_capacity``-node buckets fit their
    edges (stream density × 1.15 headroom, 1024-aligned). A too-small
    capacity makes the packer flush early and every FIXED-SHAPE bucket run
    half-empty — the silent 2× per-graph regression that hit GIN-VN/GAT
    (VN stars / self-loops exceed 3 edges per node)."""
    total_n = sum(g.num_nodes for g in graphs)
    density = sum(g.num_edges for g in graphs) / max(1, total_n)
    return -(-int(node_capacity * density * 1.15) // 1024) * 1024


def pack_dataset(
    graphs: Iterable[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
    with_eigen: bool = False,
) -> Iterator[PackedGraphs]:
    """Greedy first-fit streaming packer: yields full buckets of fixed shape.

    This is the batching analog of the reference's whole-dataset single
    enqueue (GIN/src/host.cc:203-210): the dataset becomes a stream of
    identically-shaped buckets, so XLA compiles exactly once.
    """
    bucket: list[Graph] = []
    nodes = edges = 0
    for g in graphs:
        over = (
            nodes + g.num_nodes > node_capacity
            or edges + g.num_edges > edge_capacity
            or len(bucket) >= graph_capacity
        )
        if over and bucket:
            yield pack_graphs(
                bucket, node_capacity, edge_capacity, graph_capacity, with_eigen
            )
            bucket, nodes, edges = [], 0, 0
        if g.num_nodes > node_capacity or g.num_edges > edge_capacity:
            raise ValueError("graph larger than bucket capacity")
        bucket.append(g)
        nodes += g.num_nodes
        edges += g.num_edges
    if bucket:
        yield pack_graphs(
            bucket, node_capacity, edge_capacity, graph_capacity, with_eigen
        )
