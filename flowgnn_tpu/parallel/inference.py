"""Sharded inference steps: data-parallel buckets × edge-partitioned graphs.

``sharded_forward`` jits one model over a ('data', 'edge') mesh:

  * batches are a stack of packed buckets with leading axis = data-axis size;
    each data-row is an independent bucket (pure throughput scaling, no
    communication),
  * within each bucket the edge arrays are additionally split across the
    'edge' axis; every segment reduction inside the model then produces
    partial node messages that one ``psum``/``pmin``/``pmax`` over the
    device interconnect completes (ops/segment.py) — the multi-chip mapping of the reference's
    EDGE_PARALLEL scatter PEs with private message buffers
    (GIN/src/load_inputs.cc:127, SURVEY.md §2.4).

Node/graph arrays are replicated across 'edge', so the update matmuls are
computed redundantly per edge-shard — the right trade at these model sizes
(dim ≤ 100) where the message reduction, not the matmuls, is the scaling
limit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.graphs import PackedGraphs
from ..core.numerics import FLOAT32, Precision
from ..models.base import as_batch

# Per-key sharding of a stacked batch dict: leading axis = data, and edge
# arrays additionally sharded over the edge axis (their first real axis).
_EDGE_KEYS = ("senders", "receivers", "edge_attr")


def stack_buckets(buckets: list[PackedGraphs]) -> dict:
    """Stack identically-shaped packed buckets along a leading data axis."""
    dicts = [as_batch(b) for b in buckets]
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def batch_specs(batch: dict) -> dict:
    return {
        k: P("data", "edge") if k in _EDGE_KEYS else P("data")
        for k in batch
    }


def sharded_forward(
    forward,
    mesh: Mesh,
    prec: Precision = FLOAT32,
    **fwd_kwargs,
):
    """Build a jitted sharded step: (params, stacked_batch) → [data, G+1, 1].

    ``forward`` is a model forward from models/*; edges are sharded over the
    'edge' mesh axis and the model's internal segment reductions complete
    them with interconnect collectives (edge_axis='edge').
    """

    def local_step(params, batch):
        # Inside shard_map each array is this chip's shard: batch arrays have
        # a leading data axis of 1; edge arrays hold 1/edge_size of the edges.
        squeezed = {k: v[0] for k, v in batch.items()}
        out = forward(params, squeezed, prec, edge_axis="edge", **fwd_kwargs)
        return out[None]

    def run(params, batch):
        specs = batch_specs(batch)
        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), specs),
            out_specs=P("data"),
            check_vma=False,
        )
        return fn(params, batch)

    return jax.jit(run)


def device_put_batch(batch: dict, mesh: Mesh) -> dict:
    specs = batch_specs(batch)
    return {
        k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in batch.items()
    }


# ---------------------------------------------------------------------------
# Halo-exchange path (parallel/halo.py layout) — node-partitioned shards,
# boundary-row all_to_all per layer instead of full-array psum.
# ---------------------------------------------------------------------------

_HALO_REPLICATED = ("n_node", "n_edge")


def stack_halo_buckets(halo_batches: list[dict]) -> dict:
    """Stack per-bucket halo batch dicts along a leading data axis."""
    return {
        k: np.stack([d[k] for d in halo_batches]) for k in halo_batches[0]
    }


def halo_batch_specs(batch: dict) -> dict:
    return {
        k: P("data") if k in _HALO_REPLICATED else P("data", "edge")
        for k in batch
    }


def halo_forward(
    forward,
    mesh: Mesh,
    prec: Precision = FLOAT32,
    **fwd_kwargs,
):
    """Build a jitted halo-sharded step: (params, stacked_halo_batch) →
    [data, G+1, 1].

    Every per-chip array carries leading (data, edge-shard) axes; inside
    shard_map each chip squeezes to its own shard and runs the model's halo
    branch (models/base.py:halo_exchange) — per-layer communication is one
    boundary-row all_to_all, plus one [G+1, D] readout psum.
    """

    def local_step(params, batch):
        squeezed = {
            k: (v[0] if k in _HALO_REPLICATED else v[0, 0])
            for k, v in batch.items()
        }
        out = forward(params, squeezed, prec, edge_axis="edge", **fwd_kwargs)
        return out[None]

    def run(params, batch):
        specs = halo_batch_specs(batch)
        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), specs),
            out_specs=P("data"),
            check_vma=False,
        )
        return fn(params, batch)

    return jax.jit(run)
