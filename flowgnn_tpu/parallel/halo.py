"""Halo-exchange edge sharding — the real EDGE_PARALLEL mapping.

The reference partitions edges across scatter PEs by destination
(``pe_id = v % EDGE_PARALLEL`` — GIN/src/load_inputs.cc:127) with a private
message buffer per PE. SURVEY.md §2.4 maps this across chips as *edge
partitioning with boundary-node exchange over the device interconnect*,
NOT as replicated node state + full-array psum (the fallback kept in
parallel/inference.py): with molecule-sized graphs packed contiguously,
almost every edge's endpoints land on the same chip, so the only node rows
that must move are the few that sit on the wrong side of a chip boundary.

Layout built host-side at pack time (this module):

  * the padded node axis (N+1 rows) splits into ``k`` contiguous shards of
    ``S`` rows (a multiple of ``window``) — chip i owns rows [i·S, (i+1)·S);
  * every real edge is owned by the chip of its RECEIVER; per-chip edge
    arrays are padded to a static capacity, pad lanes scatter into a
    per-chip trash row (local index S, sliced off after reduction);
  * for each ordered chip pair (j→i), the unique rows chip j must ship to
    chip i are enumerated into ``send_idx[j, i, :H]`` (static halo capacity
    H); remote senders are re-indexed into the receiving chip's *extended*
    node space ``[local rows 0..S) ‖ halo rows S + j·H + slot)``;
  * in/out-degrees are precomputed per node (the reference also builds its
    degree tables before message passing — GIN/src/load_inputs.cc:96-154).

At run time (models/base.py:halo_exchange) each layer does ONE
``lax.all_to_all`` of the [k, H, D] boundary-row buffer — O(k·H·D) bytes
over the interconnect instead of the psum path's O(N·D) — and every segment
reduction stays chip-local. The readout is the single remaining collective (a psum
of [G+1, D] graph partials, once per model).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graphs import PackedGraphs

# Defaults chosen for molecule-scale graphs: a straddling graph contributes
# at most its node count of boundary rows per chip pair.
DEFAULT_HALO_CAP = 256
EDGE_SLACK = 1.5  # per-chip edge capacity headroom over the uniform share


@dataclasses.dataclass
class HaloShape:
    k: int
    rows_per_chip: int  # S
    edge_cap_per_chip: int  # Ec
    halo_cap: int  # H


def halo_shape(
    node_capacity: int,
    edge_capacity: int,
    k: int,
    window: int = 128,
    halo_cap: int = DEFAULT_HALO_CAP,
    edge_slack: float = EDGE_SLACK,
) -> HaloShape:
    """Static per-chip shape — a pure function of bucket capacities so every
    bucket of a stream shares one compiled program."""
    n = node_capacity + 1
    s = -(-n // (k * window)) * window
    ec = -(-int(edge_capacity / k * edge_slack) // 8) * 8
    return HaloShape(k, s, ec, halo_cap)


def build_halo_batch(
    packed: PackedGraphs,
    k: int,
    window: int = 128,
    halo_cap: int = DEFAULT_HALO_CAP,
    edge_slack: float = EDGE_SLACK,
) -> dict:
    """PackedGraphs → per-chip stacked batch dict (leading axis k).

    Keys sharded over the 'edge' mesh axis: node_feat [k,S,9],
    node_graph [k,S], node_eigen [k,S,4]?, senders [k,Ec] (extended space),
    receivers [k,Ec] (local space, trash=S), edge_attr [k,Ec,3],
    halo_send_idx [k,k,H], in_deg/out_deg [k,S].
    Replicated keys: n_node, n_edge [G+1].
    """
    shape = halo_shape(
        packed.node_capacity, packed.edge_capacity, k, window, halo_cap,
        edge_slack,
    )
    s_rows, ec, hcap = shape.rows_per_chip, shape.edge_cap_per_chip, shape.halo_cap
    n = packed.node_capacity + 1
    g_cap = packed.graph_capacity
    n2 = k * s_rows

    def pad_nodes(arr, fill):
        out = np.full((n2,) + arr.shape[1:], fill, arr.dtype)
        out[:n] = arr
        return out

    node_feat = pad_nodes(packed.node_feat, 0).reshape(k, s_rows, -1)
    node_graph = pad_nodes(packed.node_graph, g_cap).reshape(k, s_rows)
    node_eigen = None
    if packed.node_eigen is not None:
        node_eigen = pad_nodes(packed.node_eigen, 0.0).reshape(k, s_rows, -1)

    senders = np.asarray(packed.senders)
    receivers = np.asarray(packed.receivers)
    edge_attr = np.asarray(packed.edge_attr)
    real = receivers < n - 1  # edges into the pad node are dropped

    in_deg = np.bincount(receivers[real], minlength=n2).astype(np.int32)
    out_deg = np.bincount(senders[real], minlength=n2).astype(np.int32)

    send_idx = np.zeros((k, k, hcap), np.int32)

    owner = receivers // s_rows
    per_chip = []
    for i in range(k):
        ei = np.nonzero(real & (owner == i))[0]
        if ei.size > ec:
            raise ValueError(
                f"edge capacity/chip {ec} < {ei.size} edges owned by chip {i}"
                " — raise edge_slack"
            )
        src = senders[ei]
        peer = src // s_rows
        s_ext = src - i * s_rows  # provisional: local coordinates
        for j in range(k):
            if j == i:
                continue
            rem = peer == j
            if not rem.any():
                continue
            rows = np.unique(src[rem])
            if rows.size > hcap:
                raise ValueError(
                    f"halo capacity {hcap} < {rows.size} boundary rows"
                    f" for chip pair {j}->{i} — raise halo_cap"
                )
            send_idx[j, i, : rows.size] = rows - j * s_rows
            slot = np.searchsorted(rows, src[rem])
            s_ext[rem] = s_rows + j * hcap + slot
        per_chip.append((ei, s_ext, receivers[ei] - i * s_rows))

    sh_send = np.full((k, ec), 0, np.int32)
    sh_recv = np.full((k, ec), s_rows, np.int32)  # trash row
    sh_attr = np.zeros((k, ec, edge_attr.shape[1]), np.int32)
    for i, (ei, s_ext, r_loc) in enumerate(per_chip):
        sh_send[i, : ei.size] = s_ext
        sh_recv[i, : ei.size] = r_loc
        sh_attr[i, : ei.size] = edge_attr[ei]

    batch = {
        "node_feat": node_feat,
        "node_graph": node_graph,
        "senders": sh_send,
        "receivers": sh_recv,
        "edge_attr": sh_attr,
        "halo_send_idx": send_idx,
        "in_deg": in_deg.reshape(k, s_rows),
        "out_deg": out_deg.reshape(k, s_rows),
        "n_node": np.asarray(packed.n_node),
        "n_edge": np.asarray(packed.n_edge),
    }
    if node_eigen is not None:
        batch["node_eigen"] = node_eigen
    if packed.node_vn is not None:
        # Analytic-VN flag shards with the node rows; a graph that
        # straddles chips gets its per-graph VN pool psum-completed in
        # models/gin.py.
        batch["vn_mask"] = pad_nodes(packed.node_vn, False).reshape(k, s_rows)
    return batch


def halo_bytes_per_layer(shape: HaloShape, dim: int, dtype_bytes: int = 4) -> int:
    """Interconnect bytes moved per layer per chip by the halo exchange."""
    return shape.k * shape.halo_cap * dim * dtype_bytes


def psum_bytes_per_layer(node_capacity: int, dim: int, dtype_bytes: int = 4) -> int:
    """Interconnect bytes the full-array psum path moves per layer per chip."""
    return (node_capacity + 1) * dim * dtype_bytes
