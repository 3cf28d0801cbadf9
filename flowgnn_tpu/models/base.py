"""Shared model building blocks over packed graph batches.

A "batch" is the dict-of-arrays view of ``core.graphs.PackedGraphs``:

  node_feat  [N+1, 9] i32   node_graph [N+1] i32   senders/receivers [E] i32
  edge_attr  [E, 3]   i32   n_node/n_edge [G+1] i32   node_eigen [N+1, 4] f32?

with one trailing pad node (index N) that every padded edge points at and one
trailing pad graph that owns every pad node. All per-node math simply includes
the pad rows (their results are never read); readout segments by graph id so
padding falls into the pad graph's row.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.features import ATOM_FEATURE_OFFSETS, BOND_FEATURE_OFFSETS
from ..core.graphs import PackedGraphs
from ..core.numerics import Precision
from ..ops.segment import segment_sum


def as_batch(packed: PackedGraphs) -> dict:
    """PackedGraphs → dict of numpy arrays ready for jnp/jit consumption."""
    batch = {
        "node_feat": packed.node_feat,
        "node_graph": packed.node_graph,
        "senders": packed.senders,
        "receivers": packed.receivers,
        "edge_attr": packed.edge_attr,
        "n_node": packed.n_node,
        "n_edge": packed.n_edge,
    }
    if packed.node_eigen is not None:
        batch["node_eigen"] = packed.node_eigen
    if packed.node_vn is not None:
        # Analytic virtual nodes (core.graphs.add_virtual_node_analytic):
        # the flag rides the batch so models/gin.py can compute the VN
        # star's messages as per-graph pool + broadcast instead of edges.
        batch["vn_mask"] = packed.node_vn
    return batch


def batch_signature(batch: dict):
    """Static program signature of a batch: the sorted (key, shape, dtype)
    tuple. Batches with equal signatures compile to the same program and
    can be stacked under one lax.scan (bench protocol)."""
    return tuple(sorted((k, v.shape, str(v.dtype)) for k, v in batch.items()))


def halo_mode(batch: dict, axis_name: Optional[str]) -> bool:
    """True when running inside a shard_map shard of the halo-exchange
    layout (parallel/halo.py): node arrays are this chip's rows, receivers
    are local (trash row = S), senders index the extended node space."""
    return axis_name is not None and "halo_send_idx" in batch


def halo_exchange(h: jnp.ndarray, batch: dict, axis_name: str) -> jnp.ndarray:
    """Ship this chip's boundary rows to every peer and return the extended
    node array [S + k·H, D] = [local rows ‖ halo rows] that the (pre-remapped)
    senders index. One lax.all_to_all of [k, H, D] over the device
    interconnect — the halo-exchange mapping of EDGE_PARALLEL (SURVEY.md
    §2.4 row 1), O(k·H·D) bytes instead of the psum path's O(N·D)."""
    send_idx = batch["halo_send_idx"]  # [k, H] — this chip's rows per peer
    k, cap = send_idx.shape
    send = jnp.take(h, send_idx.reshape(-1), axis=0).reshape(k, cap, -1)
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0, concat_axis=0)
    return jnp.concatenate([h, recv.reshape(k * cap, h.shape[1])], axis=0)


def gather_sources(
    h: jnp.ndarray, batch: dict, axis_name: Optional[str] = None
) -> jnp.ndarray:
    """h_u per edge; in halo mode the boundary rows are exchanged first and
    the gather runs against the extended node space."""
    if halo_mode(batch, axis_name):
        h = halo_exchange(h, batch, axis_name)
    return jnp.take(h, batch["senders"], axis=0)


def edge_segment_sum(
    vals: jnp.ndarray, batch: dict, axis_name: Optional[str] = None
) -> jnp.ndarray:
    """Message reduction dispatch: chip-local segment-sum with a trash row
    in halo mode (no collective — the halo exchange happened on the gather
    side); XLA segment-sum (+ psum on the replicated edge-sharded path)
    otherwise."""
    n = num_nodes_static(batch)
    if halo_mode(batch, axis_name):
        return segment_sum(vals, batch["receivers"], n + 1)[:n]
    return segment_sum(vals, batch["receivers"], n, axis_name)


def num_nodes_static(batch: dict) -> int:
    """Padded node-axis length (N+1) — static at trace time."""
    return batch["node_feat"].shape[0]


def num_graphs_static(batch: dict) -> int:
    return batch["n_node"].shape[0]


def atom_embed(table: jnp.ndarray, node_feat: jnp.ndarray, prec: Precision) -> jnp.ndarray:
    """h0[v] = Σ_f AtomTable[offset_f + feat_f[v]] (GIN/src/load_inputs.cc:174-220).

    Formulated as a multi-hot [N, 173] × table matmul instead of a 9-row
    gather; with exact 0/1 operands and full-precision accumulation it is
    the same sum.
    """
    rows = node_feat + jnp.asarray(ATOM_FEATURE_OFFSETS)[None, :]
    vocab = table.shape[0]
    iota = jnp.arange(vocab, dtype=jnp.int32)[None, None, :]
    multihot = (rows[:, :, None] == iota).astype(prec.compute_dtype).sum(axis=1)
    h = jnp.dot(
        multihot, table.astype(prec.compute_dtype),
        preferred_element_type=acc_dtype(prec), precision=dot_precision(prec),
    ).astype(prec.compute_dtype)
    return prec.q(h)


def bond_embed(table_l: jnp.ndarray, edge_attr: jnp.ndarray, prec: Precision) -> jnp.ndarray:
    """ee[e] = Σ_f BondTable_l[offset_f + attr_f[e]] (GIN/src/message_passing.cc:136-146).

    Multi-hot [E, 13] matmul like atom_embed — the same sum, exactly."""
    rows = edge_attr + jnp.asarray(BOND_FEATURE_OFFSETS)[None, :]
    vocab = table_l.shape[0]
    iota = jnp.arange(vocab, dtype=jnp.int32)[None, None, :]
    multihot = (
        (rows[:, :, None] == iota).astype(prec.compute_dtype).sum(axis=1)
    )
    ee = jnp.dot(
        multihot, table_l.astype(prec.compute_dtype),
        preferred_element_type=acc_dtype(prec), precision=dot_precision(prec),
    )
    return prec.q(ee.astype(prec.compute_dtype))


def out_degree(batch: dict, axis_name: Optional[str] = None) -> jnp.ndarray:
    """Edges-with-source-u count per node (degree_table[u]++,
    GIN/src/load_inputs.cc:130). Includes pad node slot. Halo-layout batches
    carry the degree tables precomputed host-side (parallel/halo.py), the
    way the reference precounts degrees before message passing."""
    if "out_deg" in batch:
        return batch["out_deg"]
    n = num_nodes_static(batch)
    ones = jnp.ones_like(batch["senders"], jnp.int32)
    return segment_sum(ones, batch["senders"], n, axis_name)


def in_degree(batch: dict, axis_name: Optional[str] = None) -> jnp.ndarray:
    if "in_deg" in batch:
        return batch["in_deg"]
    n = num_nodes_static(batch)
    ones = jnp.ones_like(batch["receivers"], jnp.int32)
    return segment_sum(ones, batch["receivers"], n, axis_name)


def mean_pool(
    h: jnp.ndarray,
    batch: dict,
    prec: Precision,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Per-graph mean over nodes (GIN/src/finalize.cc:38-115): divide the
    segment sum by the *graph's* node count, exactly as the device divides by
    num_of_nodes. Pad graph rows are garbage by design. ``axis_name`` is set
    only on the halo path, where each chip holds a node shard and the graph
    partials are completed with one [G+1, D] psum — the single collective
    besides the halo exchange itself."""
    g = num_graphs_static(batch)
    total = segment_sum(h, batch["node_graph"], g, axis_name)
    count = jnp.maximum(batch["n_node"], 1).astype(h.dtype)
    return prec.q(total / count[:, None])


def acc_dtype(prec: Precision):
    """Matmul accumulation dtype: f32 for f32/bf16 compute, f64 in exactness tests."""
    return jnp.float64 if prec.compute_dtype == jnp.float64 else jnp.float32


def dot_precision(prec: Precision) -> jax.lax.Precision:
    """HIGHEST for f32/f64 compute, so a GPU computes those dots in full
    precision instead of TF32; bf16 keeps bf16 operands (with f32
    accumulation via ``acc_dtype``)."""
    if prec.compute_dtype == jnp.bfloat16 or prec.default_dots:
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST


def linear(x: jnp.ndarray, w: jnp.ndarray, b: Optional[jnp.ndarray], prec: Precision) -> jnp.ndarray:
    """Reference row-major matvec: y = x @ w.T + b (GIN/src/linear.cc:5-161)."""
    y = jnp.dot(
        x, w.T, preferred_element_type=acc_dtype(prec),
        precision=dot_precision(prec),
    ).astype(prec.compute_dtype)
    if b is not None:
        y = y + b
    return prec.q(y)


def relu(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(x, 0)


def prepare_params(params: dict, prec: Precision) -> dict:
    """Cast a numpy param pytree to device dtype; in fixed mode first snap
    every weight to the ap_fixed grid as the hosts' float→ap_fixed casts do
    (GIN/src/host_load.cc:60-98)."""

    def cvt(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = prec.q_np(x)
            return jnp.asarray(x, prec.compute_dtype)
        return jnp.asarray(x)

    return jax.tree_util.tree_map(cvt, params)
