"""GIN / GIN-VN over packed batches.

Math reproduced (see reference/oracles.py:gin_forward for citations):
message m[v] = Σ_{u→v} relu(h_u + ee_l); update h' = MLP_l((1+ε)h + m) with
MLP dim→2·dim→dim, ReLU between and after except the last layer
(GIN/src/message_passing.cc:136-146, GIN/src/node_embedding.cc:117-192);
readout mean-pool → linear (GIN/src/finalize.cc:27-33).

GIN-VN is the same program over virtual-node-augmented graphs
(core.graphs.add_virtual_node ≙ GIN-VN/src/host_load.cc:129-153). The
production transform is the ANALYTIC variant (add_virtual_node_analytic):
the VN star's 2N zero-attr edges all share one constant edge embedding e0,
so its messages factor into a per-graph pool (m[vn] = Σ_real relu(h_v+e0))
plus a per-graph broadcast (m[real v] += relu(h_vn+e0)) — computed with a
segment pool (``_vn_message``) instead of materialized edges. Same math,
but the VN hub in-degree (the one edge load that grows with graph size)
disappears from the edge stream.

The FPGA drops ε (never bound to the kernel — GIN/src/host.cc:185-200), so
``fpga_eps=True`` (default) zeroes it for device parity; ``False`` restores
the trained value for parity with the original PyTorch model.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.numerics import FLOAT32, Precision
from ..ops.segment import segment_sum
from . import base as _base
from .base import (
    atom_embed,
    bond_embed,
    edge_segment_sum,
    gather_sources,
    halo_mode,
    linear,
    mean_pool,
    relu,
)


def _vn_message(
    h, table_l, batch: dict, prec: Precision, edge_axis: str | None = None
) -> jnp.ndarray:
    """Analytic VN star messages: one segment pool over graph ids + one row
    broadcast back — e0 is the (0,0,0)-attr bond embedding every star edge
    shares (GIN-VN/src/host_load.cc:137-153). Pad/gap rows belong to the
    pad graph, so their contributions land in (and return from) a row
    nothing reads — same invariant as every other per-node op.

    Under halo sharding a graph may straddle chip shards, so the
    per-graph partials are completed with one [G+1, 2D] psum over the edge
    axis — O(G·D) bytes, like the readout psum, NOT the
    O(N·D) the halo layout exists to avoid. (The replicated edge-sharded
    legacy path holds full node arrays per chip; no collective there.)"""
    ee0 = bond_embed(table_l, jnp.zeros((1, 3), jnp.int32), prec)  # [1, D]
    vn = jnp.asarray(batch["vn_mask"]).astype(h.dtype)[:, None]
    r = prec.q(relu(h + ee0)).astype(h.dtype)
    g = _base.num_graphs_static(batch)
    rcat = jnp.concatenate([r * (1 - vn), r * vn], axis=1)
    sums = segment_sum(rcat, batch["node_graph"], g)
    if halo_mode(batch, edge_axis):
        import jax

        sums = jax.lax.psum(sums, edge_axis)
    back = jnp.take(sums, batch["node_graph"], axis=0)
    d = h.shape[1]
    return (back[:, d:] * (1 - vn) + back[:, :d] * vn).astype(h.dtype)


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    fpga_eps: bool = True,
    return_intermediates: bool = False,
    edge_axis: str | None = None,
):
    """``edge_axis``: mesh axis name when edges are sharded across chips
    (partial per-chip messages all-reduced over the device interconnect —
    SURVEY.md §2.4)."""
    L = params["mlp1_w"].shape[0]
    eps = jnp.zeros(L, prec.compute_dtype) if fpga_eps else params["eps"]

    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    vn = "vn_mask" in batch  # analytic virtual nodes (GIN-VN)
    for l in range(L):
        ee = bond_embed(params["edge_embedding"][l], batch["edge_attr"], prec)
        msg = relu(gather_sources(h, batch, edge_axis) + ee)
        agg = edge_segment_sum(msg, batch, edge_axis)
        if vn:
            agg = agg + _vn_message(
                h, params["edge_embedding"][l], batch, prec, edge_axis
            )
        m = prec.q(agg)
        act = prec.q(m + (1 + eps[l]) * h)
        z = relu(linear(act, params["mlp1_w"][l], params["mlp1_b"][l], prec))
        z = linear(z, params["mlp2_w"][l], params["mlp2_b"][l], prec)
        if l != L - 1:
            z = relu(z)
        h = z
        inter.append(h)

    h_graph = mean_pool(
        h, batch, prec, edge_axis if halo_mode(batch, edge_axis) else None
    )
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
