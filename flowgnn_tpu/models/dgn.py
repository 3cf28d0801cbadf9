"""DGN over packed batches (mean + directional-derivative channels, dim 100).

Math reproduced (see reference/oracles.py:dgn_forward for citations):
two-channel messages m1 = Σ h_u, m2 = Σ (eig_u − eig_v)·h_u using Laplacian
eigenvector component [1] (DGN/src/message_passing.cc:120-153,
DGN/src/load_inputs.cc:105-110); update a1 = m1/deg,
a2 = |m2 − eigw_sum·h| / eig_abssum (zero → 2^-13 ulp of ap_fixed<16,3>),
posttrans [dim,2,dim] linear, residual h + relu(acc)
(DGN/src/node_embedding.cc:107-160); readout MLP dim→50→25→1
(DGN/src/finalize.cc:35-52).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.numerics import FLOAT32, Precision
from ..ops.segment import segment_sum
from .base import (
    edge_segment_sum, gather_sources, halo_exchange, halo_mode, linear,
    mean_pool, out_degree, relu,
)

EIG_EPS = 1.0 / 8192  # ap_fixed_epsilon<ap_fixed<16,3>> (DGN/src/node_embedding.cc:125)


def _atom_embed_dgn(tables: jnp.ndarray, node_feat: jnp.ndarray, prec: Precision):
    """DGN keeps 9 separate [119, dim] tables (DGN/src/load_inputs.cc:114-137);
    the used rows of each (vocab_f ≤ 119) are concatenated into the compact
    [173, dim] layout the other models use, so the lookup-sum runs as
    base.atom_embed's multi-hot matmul (the same sum, exactly)."""
    from ..core.features import ATOM_FEATURE_DIMS
    from .base import atom_embed

    compact = jnp.concatenate(
        [tables[i, :v] for i, v in enumerate(ATOM_FEATURE_DIMS)], axis=0
    )
    return atom_embed(compact, node_feat, prec)


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
    edge_axis: str | None = None,
):
    u, v = batch["senders"], batch["receivers"]
    n = batch["node_feat"].shape[0]
    L = params["posttrans_w"].shape[0]
    dt = prec.compute_dtype

    eig = batch["node_eigen"][:, 1].astype(dt)
    halo = halo_mode(batch, edge_axis)
    if halo:
        # eig is layer-constant: one boundary-row exchange covers all layers;
        # the two per-node eig sums then reduce chip-locally (trash row S).
        eig_ext = halo_exchange(eig[:, None], batch, edge_axis)[:, 0]
        eig_w = prec.q(jnp.take(eig_ext, u) - jnp.take(eig, v))
        eig_abssum = segment_sum(jnp.abs(eig_w), v, n + 1)[:n]
        eigw_sum = prec.q(segment_sum(eig_w, v, n + 1)[:n])
    else:
        eig_w = prec.q(jnp.take(eig, u) - jnp.take(eig, v))
        eig_abssum = segment_sum(jnp.abs(eig_w), v, n, edge_axis)
        eigw_sum = prec.q(segment_sum(eig_w, v, n, edge_axis))
    eig_abssum = prec.q(jnp.where(eig_abssum == 0, EIG_EPS, eig_abssum))
    # The device divides by the raw out-degree with no zero guard
    # (DGN/src/node_embedding.cc:145); clamp for isolated nodes (message 0).
    deg = jnp.maximum(out_degree(batch, edge_axis), 1).astype(dt)[:, None]

    h = _atom_embed_dgn(params["atom_tables"], batch["node_feat"], prec)
    inter = [h]
    for l in range(L):
        x = gather_sources(h, batch, edge_axis)
        d = x.shape[1]
        mm = edge_segment_sum(
            jnp.concatenate([x, eig_w[:, None] * x], axis=1), batch, edge_axis
        )
        m1, m2 = prec.q(mm[:, :d]), prec.q(mm[:, d:])
        a1 = prec.q(m1 / deg)
        a2 = prec.q(jnp.abs(m2 - eigw_sum[:, None] * h) / eig_abssum[:, None])
        # Fused two-channel linear: concat channels → one matmul against
        # the [dim_out, 2·dim_in] reshaped posttrans weight.
        a = jnp.concatenate([a1, a2], axis=1)
        w = params["posttrans_w"][l].reshape(params["posttrans_w"].shape[1], -1)
        acc = linear(a, w, params["posttrans_b"][l], prec)
        h = prec.q(h + relu(acc))
        inter.append(h)

    h_graph = mean_pool(h, batch, prec, edge_axis if halo else None)
    z = relu(linear(h_graph, params["mlp1_w"], params["mlp1_b"], prec))
    z = relu(linear(z, params["mlp2_w"], params["mlp2_b"], prec))
    out = linear(z, params["mlp3_w"], params["mlp3_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
