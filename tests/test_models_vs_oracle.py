"""JAX packed models vs independent NumPy oracles, on seeded weights.

This is the automated version of the reference's manual golden-output
comparison (SURVEY.md §4): for every model family, run the per-graph NumPy
oracle and the packed/jitted JAX model on the same synthetic graphs with the
same seeded weights at the published widths, and require per-graph
agreement.
"""

import jax
import numpy as np
import pytest

from conftest import assert_allclose, seeded_params
from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from flowgnn_tpu.core.numerics import FLOAT32, FLOAT64, Precision
from flowgnn_tpu.reference import oracles

CAPS = dict(node_capacity=1024, edge_capacity=4096, graph_capacity=32)

ALL_MODELS = ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"]


def run_jax(name, graphs, prec: Precision):
    spec = registry.get(name)
    params = seeded_params(name)
    tg = registry.apply_transforms(spec, graphs)
    packed = pack_graphs(tg, with_eigen=spec.needs_eigen, **CAPS)
    batch = as_batch(packed)
    jparams = prepare_params(params, prec)
    fwd = jax.jit(lambda p, b: spec.forward(p, b, prec))
    return np.asarray(fwd(jparams, batch))[: len(graphs), 0], params


def run_oracle(name, graphs, params):
    spec = registry.get(name)
    oracle = oracles.ORACLES["gin" if name == "gin-vn" else name]
    # The oracle consumes transformed graphs, except GAT whose oracle adds
    # self loops internally (it gets the raw graphs) and GIN-VN whose
    # production transform is the ANALYTIC virtual node — the oracle gets
    # the materialized star (core.graphs.add_virtual_node) instead, so the
    # two-way validation crosses the analytic/edge-based formulations.
    if name == "gat":
        og = graphs
    elif name == "gin-vn":
        from flowgnn_tpu.core.graphs import add_virtual_node

        og = [add_virtual_node(g) for g in graphs]
    else:
        og = registry.apply_transforms(spec, graphs)
    return np.array([oracle(params, g)["out"].ravel()[0] for g in og])


@pytest.mark.parametrize("name", ALL_MODELS)
def test_model_matches_oracle_f64(name, graphs16):
    """Exactness: f64 JAX model vs f64 NumPy oracle — near machine precision."""
    out, params = run_jax(name, graphs16, FLOAT64)
    expected = run_oracle(name, graphs16, params)
    # DGN's directional derivative |m2 − eigw_sum·h|/abssum amplifies
    # reduction-order noise by near-cancellation; still ≤1e-6 in f64.
    tol = 1e-6 if name == "dgn" else 1e-9
    assert_allclose(out, expected, rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("name", ALL_MODELS)
def test_model_f32_drift(name, graphs16):
    """f32 production path drifts from exact math only by reduction noise."""
    out, params = run_jax(name, graphs16, FLOAT32)
    expected = run_oracle(name, graphs16, params)
    assert_allclose(out, expected, rtol=2e-2, atol=1e-3, msg=name)


def test_gin_eps_mode(graphs16):
    """fpga_eps=False must use the trained ε and change the result."""
    spec = registry.get("gin")
    params = seeded_params("gin")
    assert np.any(params["eps"] != 0)
    packed = pack_graphs(graphs16, **CAPS)
    batch = as_batch(packed)
    jp = prepare_params(params, FLOAT32)
    a = spec.forward(jp, batch, FLOAT32, fpga_eps=True)
    b = spec.forward(jp, batch, FLOAT32, fpga_eps=False)
    assert not np.allclose(np.asarray(a)[:16], np.asarray(b)[:16])
