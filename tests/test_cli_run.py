"""CLI run_case — the host-program analog (host.cc:203-222 + XRT summary).

End-to-end on CPU: stream a tiny synthetic dataset, check the prediction
file (HLS_output.txt analog, ``g%d: %.8f`` lines), the XRT-shaped kernel
summary CSV, and that the written predictions equal the direct jitted
forward on the same graphs.
"""

import numpy as np
import pytest

from conftest import assert_allclose, seeded_params
from flowgnn_tpu.cli import run_case
from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.core.numerics import FLOAT32
from flowgnn_tpu.core.synthetic import synthetic_molhiv
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params


def test_run_case_artifacts_and_predictions(tmp_path):
    import jax

    r = run_case(
        "gin", "synth", trials=2, out_dir=str(tmp_path), prec=FLOAT32,
        num_graphs=6, caps=(512, 2048, 8),
    )
    assert r["model"] == "gin" and r["num_graphs"] == 6
    assert r["device"]["platform"] == jax.devices()[0].platform
    assert r["avg_ms"] > 0 and r["graphs_per_s"] > 0

    lines = (tmp_path / "gin_output.txt").read_text().strip().splitlines()
    assert len(lines) == 6
    assert lines[0].startswith("g1: ") and lines[5].startswith("g6: ")
    preds = np.array([float(l.split(": ")[1]) for l in lines])

    csv = (tmp_path / "summary.gin.csv").read_text().splitlines()
    assert csv[0] == "Kernel Execution"
    assert csv[2].startswith("gin_compute_graphs,2,")

    # Written predictions == direct jitted forward on the same stream.
    spec = registry.get("gin")
    jp = prepare_params(seeded_params("gin"), FLOAT32)
    graphs = synthetic_molhiv(6, seed=0)
    packed = pack_graphs(
        graphs, node_capacity=512, edge_capacity=2048, graph_capacity=8
    )
    direct = np.asarray(
        jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))(jp, as_batch(packed))
    )[:6, 0]
    assert_allclose(preds, direct, rtol=1e-6, atol=1e-6)
