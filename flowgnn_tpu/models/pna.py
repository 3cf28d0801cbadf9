"""PNA over packed batches (4 aggregators × 3 scalers, dim 80, 4 layers).

Math reproduced (see reference/oracles.py:pna_forward for citations):
multi-stat segment reduce (sum, sum², running min/max seeded at the ap_fixed
extremes — PNA/src/message_passing.cc:121-147), degree-normalised mean/std,
scalers (1, t, 1/t) from log(out_deg+1)/avg_deg
(PNA/src/node_embedding.cc:123-214), one fused [dim,3,4,dim] tower, residual
h + relu(acc), readout MLP dim→40→20→1 (PNA/src/finalize.cc:34-52).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.numerics import FLOAT32, Precision
from ..ops.segment import segment_max, segment_min
from .base import (
    atom_embed, edge_segment_sum, gather_sources, halo_mode, in_degree,
    linear, mean_pool, out_degree, relu,
)

# ap_fixed<16,6> extremes used to seed the running min/max accumulators
# (PNA/src/util.h ap_fixed_min/max).
MIN_INIT = -32.0
MAX_INIT = 32767 / 1024


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
    edge_axis: str | None = None,
):
    v = batch["receivers"]
    n = batch["node_feat"].shape[0]
    L = params["conv_w"].shape[0]
    dt = prec.compute_dtype

    # Reference asymmetry preserved: mean divides by in-degree (0→1), the
    # scalers use log(out_degree+1) (PNA/src/load_inputs.cc:87-105).
    in_deg = jnp.maximum(in_degree(batch, edge_axis), 1).astype(dt)[:, None]
    log_deg = jnp.log(out_degree(batch, edge_axis).astype(dt) + 1)[:, None]
    avg_deg = params["avg_deg"]
    t = prec.q(log_deg / avg_deg)
    scale = prec.q(
        jnp.where(log_deg > 0, avg_deg / jnp.where(log_deg > 0, log_deg, 1), 1.0)
    )

    halo = halo_mode(batch, edge_axis)
    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    for l in range(L):
        d = h.shape[1]
        x = gather_sources(h, batch, edge_axis)
        ss = edge_segment_sum(
            jnp.concatenate([x, x * x], axis=1), batch, edge_axis
        )
        s, s2 = ss[:, :d], ss[:, d:]
        if halo:
            # Chip-local running min/max over the trash-row segment space
            # — no pmin/pmax collective on the halo path.
            mn = segment_min(x, v, n + 1, MAX_INIT)[:n]
            mx = segment_max(x, v, n + 1, MIN_INIT)[:n]
        else:
            mn = segment_min(x, v, n, MAX_INIT, edge_axis)
            mx = segment_max(x, v, n, MIN_INIT, edge_axis)
        mean = prec.q(s / in_deg)
        std = prec.q(jnp.sqrt(relu(prec.q(s2 / in_deg) - mean * mean)))
        # [n, 4·dim] in enum order (mean, min, max, std) — PNA/src/dcl.h:29-35.
        stats = jnp.concatenate([mean, mn, mx, std], axis=1)
        # The tower is linear in the stats, so the three scalers distribute:
        #   acc = W_none·stats + t·(W_t·stats) + scale·(W_scale·stats)
        # — three [4D→D] matmuls instead of materialising the [n, 12·D]
        # scaled-stats tensor.
        wl = params["conv_w"][l]  # [D_out, 3, 4, D_in]
        d_out = wl.shape[0]
        w_none = wl[:, 0].reshape(d_out, -1)
        w_t = wl[:, 1].reshape(d_out, -1)
        w_scale = wl[:, 2].reshape(d_out, -1)
        acc = (
            linear(stats, w_none, params["conv_b"][l], prec)
            + t * linear(stats, w_t, None, prec)
            + scale * linear(stats, w_scale, None, prec)
        )
        acc = prec.q(acc)
        h = prec.q(h + relu(acc))
        inter.append(h)

    h_graph = mean_pool(h, batch, prec, edge_axis if halo else None)
    z = relu(linear(h_graph, params["mlp1_w"], params["mlp1_b"], prec))
    z = relu(linear(z, params["mlp2_w"], params["mlp2_b"], prec))
    out = linear(z, params["mlp3_w"], params["mlp3_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
