"""Halo-exchange edge sharding: multi-chip == single-chip on the fake mesh.

Validates the node-partition + boundary-row-all_to_all mapping of
EDGE_PARALLEL (parallel/halo.py, SURVEY.md §2.4 row 1) for all six models,
plus the layout invariants and the communication-volume accounting that
motivates the design.
"""

import jax
import numpy as np
import pytest

from conftest import assert_allclose, seeded_params
from flowgnn_tpu.core.graphs import Graph, pack_graphs
from flowgnn_tpu.core.numerics import FLOAT32
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from flowgnn_tpu.parallel.halo import (
    build_halo_batch,
    halo_bytes_per_layer,
    halo_shape,
    psum_bytes_per_layer,
)
from flowgnn_tpu.parallel.inference import halo_forward, stack_halo_buckets
from flowgnn_tpu.parallel.mesh import make_mesh

CAPS = dict(node_capacity=512, edge_capacity=2048, graph_capacity=16)
ALL_MODELS = ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"]


def test_halo_layout_invariants(graphs16):
    packed = pack_graphs(graphs16, **CAPS)
    k = 4
    batch = build_halo_batch(packed, k=k, window=64)
    shape = halo_shape(packed.node_capacity, packed.edge_capacity, k, window=64)
    s = shape.rows_per_chip

    # Every real edge appears exactly once across chips, owned by its
    # receiver's chip; receivers are in-range local (or trash).
    n = packed.node_capacity + 1
    real = packed.receivers < n - 1
    total_real = int(real.sum())
    kept = int((batch["receivers"] < s).sum())
    assert kept == total_real
    assert batch["receivers"].max() <= s
    # Senders index the extended space [0, S + k·H).
    assert batch["senders"].max() < s + k * shape.halo_cap
    # Degree tables match a direct bincount.
    np.testing.assert_array_equal(
        batch["in_deg"].reshape(-1)[:n][: n - 1],
        np.bincount(packed.receivers[real], minlength=n)[: n - 1],
    )
    # Reconstruct each chip's edges back to global coordinates and compare
    # message results against a direct segment sum.
    rng = np.random.default_rng(0)
    hval = rng.normal(size=(k * s, 3)).astype(np.float32)
    expect = np.zeros((k * s, 3), np.float32)
    for e in np.nonzero(real)[0]:
        expect[packed.receivers[e]] += hval[packed.senders[e]]
    got = np.zeros((k * s, 3), np.float32)
    hcap = shape.halo_cap
    for i in range(k):
        ext = np.concatenate(
            [hval[i * s : (i + 1) * s]]
            + [hval[j * s : j * s + s][batch["halo_send_idx"][j, i]]
               for j in range(k)]
        )
        for lane in range(batch["senders"].shape[1]):
            rv = batch["receivers"][i, lane]
            if rv < s:
                got[i * s + rv] += ext[batch["senders"][i, lane]]
    np.testing.assert_allclose(got, expect, rtol=1e-6)


@pytest.mark.parametrize("name", ALL_MODELS)
@pytest.mark.parametrize("data,edge", [(2, 4), (1, 8)])
def test_halo_equals_single(name, data, edge, graphs16):
    if len(jax.devices()) < data * edge:
        pytest.skip("needs 8 fake devices")
    spec = registry.get(name)
    jparams = prepare_params(seeded_params(name), FLOAT32)
    tg = registry.apply_transforms(spec, graphs16)

    per = max(1, len(tg) // max(data, 1))
    buckets = [
        pack_graphs(tg[i * per : (i + 1) * per], with_eigen=spec.needs_eigen, **CAPS)
        for i in range(data)
    ]
    stacked = stack_halo_buckets(
        [build_halo_batch(b, k=edge, window=64, edge_slack=8.0) for b in buckets]
    )

    mesh = make_mesh(data=data, edge=edge)
    fwd = halo_forward(spec.forward, mesh, FLOAT32)
    sharded_out = np.asarray(fwd(jparams, stacked))

    single = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))
    for i, b in enumerate(buckets):
        expected = np.asarray(single(jparams, as_batch(b)))
        got = sharded_out[i]
        kk = b.num_graphs
        assert_allclose(got[:kk], expected[:kk], rtol=1e-5, atol=1e-5,
                        msg=f"{name} bucket {i} mesh {data}x{edge} halo")


def test_halo_handles_straddling_graph():
    """A graph bigger than one chip's shard: its crossing edges must ride the
    halo exchange (ring of 200 nodes over 4 chips of 64-row shards... the
    shard size comes out of halo_shape)."""
    n = 200
    ei = np.stack(
        [np.arange(n), np.roll(np.arange(n), -1)], axis=1
    ).astype(np.int32)
    ei = np.concatenate([ei, ei[:, ::-1]])  # both directions
    rng = np.random.default_rng(1)
    g = Graph(rng.integers(0, 2, (n, 9)).astype(np.int32), ei,
              np.zeros((ei.shape[0], 3), np.int32))
    spec = registry.get("gin")
    jparams = prepare_params(seeded_params("gin"), FLOAT32)
    caps = dict(node_capacity=256, edge_capacity=1024, graph_capacity=4)
    packed = pack_graphs([g], **caps)
    k = 4
    stacked = stack_halo_buckets([build_halo_batch(packed, k=k, window=32, edge_slack=8.0)])
    mesh = make_mesh(data=1, edge=k)
    fwd = halo_forward(spec.forward, mesh, FLOAT32)
    got = np.asarray(fwd(jparams, stacked))[0]
    expected = np.asarray(
        jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))(jparams, as_batch(packed))
    )
    assert_allclose(got[:1], expected[:1], rtol=1e-5, atol=1e-5)


def test_halo_moves_fewer_bytes():
    """The design's point: boundary-row exchange moves asymptotically less
    than the full-array psum as buckets grow."""
    shape = halo_shape(node_capacity=32768, edge_capacity=98304, k=8)
    halo = halo_bytes_per_layer(shape, dim=100)
    psum = psum_bytes_per_layer(node_capacity=32768, dim=100)
    assert halo < psum / 10  # 8·256·100·4 ≈ 0.8 MB vs 32k·100·4 ≈ 13 MB
