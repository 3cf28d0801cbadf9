"""GAT over packed batches (4 heads × dim 16, self edges, no edge features).

Math reproduced (see reference/oracles.py:gat_forward for citations). The
reference software-pipelines layers — each layer's apply unit eagerly computes
the *next* layer's projection and attention scores
(GAT/src/node_embedding.cc:98-271, weights indexed [layer+1]); here the same
math runs in natural order. Edge softmax uses raw exp with no
max-subtraction, matching GAT/src/message_passing.cc:122-148 — fine for
parity at dim-16 fixed-point scale, and kept so numerics line up.

Self edges must already be present in the batch
(core.graphs.add_self_loops ≙ GAT/src/load_inputs.cc:144-149).

Documented reference bug (not reproduced): GAT_compute.cc forgets
``nodes_offset`` when loading input features — in a multi-graph batch the
reference kernel evaluates EVERY graph on graph 1's node features (GIN/PNA/
DGN pass the offset correctly). This framework uses each graph's own
features; bit-exact validation therefore runs the golden kernel one graph
per batch (tests/test_golden.py::test_gat_bit_exact_vs_reference_kernel,
and ..::test_gat_reference_feature_offset_bug pins the bug itself).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.numerics import FLOAT32, Precision
from .base import (
    acc_dtype, dot_precision, edge_segment_sum, halo_exchange, halo_mode,
    linear, mean_pool,
)

LEAKY_SLOPE = 0.2


def _project(w_l: jnp.ndarray, x: jnp.ndarray, prec: Precision) -> jnp.ndarray:
    """[head_out, dim_out, head_in, dim_in] × [n, head_in, dim_in].

    Flattened to a single (n, H·D) @ (H·D, H·D) matmul — one dense op
    instead of 16 head-pair matmuls.
    """
    n = x.shape[0]
    ho, do, hi, di = w_l.shape
    y = jnp.dot(
        x.reshape(n, hi * di),
        w_l.reshape(ho * do, hi * di).T,
        preferred_element_type=acc_dtype(prec),
        precision=dot_precision(prec),
    ).astype(prec.compute_dtype)
    return prec.q(y.reshape(n, ho, do))


def _scores(h: jnp.ndarray, a: jnp.ndarray, prec: Precision) -> jnp.ndarray:
    """s[v, head] = Σ_dim h[v,head,dim]·a[head,dim] (GAT/src/load_inputs.cc:203-227)."""
    return prec.q(
        jnp.einsum(
            "nhd,hd->nh", h, a, precision=dot_precision(prec)
        ).astype(prec.compute_dtype)
    )


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
    edge_axis: str | None = None,
):
    u, v = batch["senders"], batch["receivers"]
    n = batch["node_feat"].shape[0]
    L, H, D = params["proj_w"].shape[:3]

    # prev = raw int features in head-0 slots (GAT/src/load_inputs.cc:168-227).
    prev = jnp.zeros((n, H, D), prec.compute_dtype)
    prev = prev.at[:, 0, :9].set(batch["node_feat"].astype(prec.compute_dtype))

    h = _project(params["proj_w"][0], prev, prec)  # [n, head_out, dim_out]
    s_src = _scores(h, params["a_src"][0], prec)
    s_tgt = _scores(h, params["a_tgt"][0], prec)

    halo = halo_mode(batch, edge_axis)
    inter = [h]
    out_feat = None
    for l in range(L):
        if halo:
            # One exchange per layer ships h and s_tgt together (both are
            # gathered by sender); s_src is gathered by receiver → local.
            ext = halo_exchange(
                jnp.concatenate([h.reshape(n, H * D), s_tgt], axis=1),
                batch, edge_axis,
            )
            h_src, s_tgt_src = ext[:, : H * D], ext[:, H * D :]
        else:
            h_src, s_tgt_src = h.reshape(n, H * D), s_tgt
        raw = jnp.take(s_src, v, axis=0) + jnp.take(s_tgt_src, u, axis=0)  # [E, H]
        score = prec.q(jnp.exp(jnp.where(raw < 0, raw * LEAKY_SLOPE, raw)))
        h_u = jnp.take(h_src, u, axis=0).reshape(-1, H, D)
        # One fused reduction: [E, H·D] scored features ++ [E, H] scores.
        scored = (score[:, :, None] * h_u).reshape(-1, H * D)
        both = edge_segment_sum(
            jnp.concatenate([scored, score], axis=1), batch, edge_axis
        )
        msg = both[:, : H * D].reshape(n, H, D)
        denom = both[:, H * D :]
        # Pad nodes receive no edges; keep the division defined.
        msg = prec.q(msg / jnp.where(denom == 0, 1, denom)[:, :, None])
        skip = _project(params["skip_w"][l], prev, prec)
        if l != L - 1:
            feat = msg + skip
            feat = prec.q(jnp.where(feat <= 0, jnp.exp(feat) - 1, feat))  # ELU
            prev = feat
            h = _project(params["proj_w"][l + 1], feat, prec)
            s_src = _scores(h, params["a_src"][l + 1], prec)
            s_tgt = _scores(h, params["a_tgt"][l + 1], prec)
            inter.append(h)
        else:
            out_feat = prec.q((msg + skip).sum(axis=1) / H)  # head average

    h_graph = mean_pool(out_feat, batch, prec, edge_axis if halo else None)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
