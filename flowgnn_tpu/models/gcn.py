"""GCN over packed batches.

Math reproduced (see reference/oracles.py:gcn_forward for citations): the
reference fuses the previous layer's tail (root-emb residual, BatchNorm,
ReLU) in front of each conv matmul (GCN/src/node_embedding.cc:122-146) and
fuses the final tail (no ReLU) into pooling (GCN/src/finalize.cc:39-113);
expressed sequentially here, same math. Messages are norm-scaled
relu(h_u + ee_l) with norm_uv = 1/√(deg_u+1)/√(deg_v+1)
(GCN/src/load_inputs.cc:121-163, GCN/src/message_passing.cc:148-167).

Documented deviation: the reference leaves degree_inv_sqrt[v]=0 for nodes
never seen as a source (norm=0 on their in-edges); we use 1/sqrt(0+1)=1.
Identical on symmetric OGB edge lists, divergent on directed inputs (see
reference/oracles.py:gcn_forward).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.numerics import FLOAT32, Precision
from .base import (
    atom_embed, bond_embed, edge_segment_sum, gather_sources, halo_exchange,
    halo_mode, linear, mean_pool, out_degree, relu,
)

# Device BatchNorm uses sqrt(var + ap_fixed ulp) (GCN/src/load_inputs.cc:33).
BN_EPS = 1.0 / 1024


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
    edge_axis: str | None = None,
):
    u, v = batch["senders"], batch["receivers"]
    L = params["conv_w"].shape[0]

    deg = out_degree(batch, edge_axis).astype(prec.compute_dtype)
    dis = 1.0 / jnp.sqrt(deg + 1)
    halo = halo_mode(batch, edge_axis)
    # dis is layer-constant: in halo mode one boundary-row exchange covers
    # all layers (sender-side gathers use the extended space).
    dis_src = halo_exchange(dis[:, None], batch, edge_axis)[:, 0] if halo else dis
    norm = prec.q((jnp.take(dis_src, u) * jnp.take(dis, v))[:, None])

    def bn(x, l):
        s = jnp.sqrt(params["bn_var"][l] + BN_EPS)
        return prec.q(
            (x - params["bn_mean"][l]) / s * params["bn_weight"][l]
            + params["bn_bias"][l]
        )

    def tail(m, h, l):
        a = m + relu(h + params["root_emb"][l]) / (deg[:, None] + 1)
        return bn(prec.q(a), l)

    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    m = jnp.zeros_like(h)
    inter = [h]
    for l in range(L):
        a = h if l == 0 else relu(tail(m, h, l - 1))
        h = linear(a, params["conv_w"][l], params["conv_b"][l], prec)
        ee = bond_embed(params["edge_embedding"][l], batch["edge_attr"], prec)
        msg = norm * relu(gather_sources(h, batch, edge_axis) + ee)
        m = prec.q(edge_segment_sum(msg, batch, edge_axis))
        inter.append(h)

    a = tail(m, h, L - 1)  # final tail has no ReLU (GCN/src/finalize.cc:88-96)
    h_graph = mean_pool(a, batch, prec, edge_axis if halo else None)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
