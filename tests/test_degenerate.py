"""Degenerate inputs through the production layouts.

The reference accepts any graph stream from graph_bin — a bond-less molecule
is legal input (the host loop simply reads 0 edges, GIN/src/host.cc:126-143,
and the kernel's CSR pass leaves every degree 0). All six model forwards and
the halo layout must survive zero-edge / single-node graphs packed into a
normal bucket, and agree with the f64 oracles on them — this exercises the
zero-degree guards (PNA's log(deg+1)=0 rows, DGN's 2^-13 eig_abssum guard,
GAT's self-loop-only softmax).
"""

import numpy as np
import pytest

from conftest import assert_allclose, seeded_params
from flowgnn_tpu.core.graphs import Graph, pack_graphs
from flowgnn_tpu.core.numerics import FLOAT32, FLOAT64
from flowgnn_tpu.core.synthetic import synthetic_molhiv
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from test_models_vs_oracle import run_jax, run_oracle

ALL_MODELS = ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"]
CAPS = dict(node_capacity=128, edge_capacity=512, graph_capacity=8)


@pytest.fixture(scope="module")
def degenerate():
    """1-node/0-edge, 3-node/0-edge, 2-node/1-edge, plus one normal graph."""
    rng = np.random.default_rng(3)

    def mk(n, edges):
        return Graph(
            node_feat=rng.integers(0, 2, size=(n, 9)).astype(np.int32),
            edge_index=np.asarray(edges, np.int32).reshape(-1, 2),
            edge_attr=rng.integers(0, 2, size=(len(edges), 3)).astype(np.int32),
            node_eigen=rng.standard_normal((n, 4)).astype(np.float32),
        ).validate()

    normal = synthetic_molhiv(1, seed=5, with_eigen=True)[0]
    return [mk(1, []), mk(3, []), mk(2, [(0, 1)]), normal]


@pytest.mark.parametrize("name", ALL_MODELS)
def test_degenerate_matches_oracle_f64(name, degenerate):
    """Zero-edge graphs: packed JAX model == per-graph NumPy oracle."""
    out, params = run_jax(name, degenerate, FLOAT64)
    expected = run_oracle(name, degenerate, params)
    tol = 1e-6 if name == "dgn" else 1e-9
    assert_allclose(out, expected, rtol=tol, atol=tol, msg=name)


def test_degenerate_halo_forward(degenerate):
    """Halo edge sharding with chips that own ZERO real edges (bond-less
    stream): empty boundary sets and all-zero exchanges must be no-ops."""
    import jax

    from flowgnn_tpu.parallel.halo import build_halo_batch
    from flowgnn_tpu.parallel.inference import halo_forward, stack_halo_buckets
    from flowgnn_tpu.parallel.mesh import make_mesh

    edgeless = degenerate[:2]  # 1-node and 3-node graphs, zero edges total
    spec = registry.get("gin")
    jp = prepare_params(seeded_params("gin"), FLOAT32)
    packed = pack_graphs(edgeless, **CAPS)
    k = 4
    if len(jax.devices()) < k:
        pytest.skip("needs 4 fake devices")
    stacked = stack_halo_buckets(
        [build_halo_batch(packed, k=k, window=32, edge_slack=8.0)]
    )
    mesh = make_mesh(data=1, edge=k)
    got = np.asarray(halo_forward(spec.forward, mesh, FLOAT32)(jp, stacked))[0]
    expected = np.asarray(
        jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))(jp, as_batch(packed))
    )
    assert_allclose(got[:2], expected[:2], rtol=1e-5, atol=1e-5)
