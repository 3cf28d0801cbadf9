"""Segment primitives — the replacement for FlowGNN's scatter PEs.

The reference partitions edges across 4 scatter PEs by ``dest % 4`` with
private message BRAMs so concurrent accumulation is conflict-free
(GIN/src/load_inputs.cc:127, GIN/src/message_passing.cc:77-150). Here the
same computation is a ``segment_sum`` over a packed edge axis, which XLA
lowers to a scatter (atomic adds on a GPU), and the padded-edge convention
(pad edges → pad node) keeps every index in bounds with no masking in the hot
loop.

Cross-chip edge partitioning (SURVEY.md §2.4's mapping of EDGE_PARALLEL) uses
the same functions with ``axis_name`` set: inside a ``shard_map`` whose edge
arrays are sharded over that mesh axis, each chip reduces its local edge
shard and the partial node messages are combined with one XLA collective over
the device interconnect (psum / pmin / pmax) — the multi-chip analog of the per-PE private
message buffers being merged.

All functions take ``num_segments`` statically so shapes stay trace-stable.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


def segment_sum(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    axis_name: Optional[str] = None,
    indices_are_sorted: bool = False,
) -> jnp.ndarray:
    out = jax.ops.segment_sum(
        data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted
    )
    if axis_name is not None:
        out = lax.psum(out, axis_name)
    return out


def segment_mean(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    total = segment_sum(data, segment_ids, num_segments, axis_name)
    count = segment_sum(
        jnp.ones(data.shape[:1], data.dtype), segment_ids, num_segments, axis_name
    )
    return total / jnp.maximum(count, 1)[(...,) + (None,) * (data.ndim - 1)]


def segment_min(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    init: float,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Running-min with a finite seed value, matching the reference's
    fixed-point accumulator initialisation (PNA/src/message_passing.cc
    reset_message): result = min(init, min over segment values); empty
    segments stay at ``init``."""
    out = jax.ops.segment_min(data, segment_ids, num_segments)
    out = jnp.minimum(jnp.nan_to_num(out, posinf=init), init)
    if axis_name is not None:
        out = lax.pmin(out, axis_name)
    return out


def segment_max(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    init: float,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    out = jax.ops.segment_max(data, segment_ids, num_segments)
    out = jnp.maximum(jnp.nan_to_num(out, neginf=init), init)
    if axis_name is not None:
        out = lax.pmax(out, axis_name)
    return out
