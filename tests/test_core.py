"""Core container, IO round-trip, transform, and numerics tests."""

import numpy as np
import pytest

from conftest import assert_allclose
from flowgnn_tpu.core import io as gio
from flowgnn_tpu.core.graphs import (
    Graph,
    add_self_loops,
    add_virtual_node,
    laplacian_eigenvectors,
    pack_dataset,
    pack_graphs,
)
from flowgnn_tpu.core.numerics import AP_FIXED_16_3, AP_FIXED_16_6
from flowgnn_tpu.core.synthetic import synthetic_molhiv


def test_synthetic_shapes(graphs16):
    for g in graphs16:
        g.validate()
        # Bidirectional edge storage (OGB convention).
        fwd = {(int(a), int(b)) for a, b in g.edge_index}
        assert all((b, a) in fwd for a, b in fwd)


def test_io_roundtrip(tmp_path, graphs16):
    gio.write_dataset(str(tmp_path), graphs16[:4])
    back = list(gio.read_dataset(str(tmp_path), with_eigen=True))
    assert len(back) == 4
    for a, b in zip(graphs16[:4], back):
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_attr, b.edge_attr)
        # eig text format stores 4 decimals; loose check.
        assert_allclose(a.node_eigen, b.node_eigen, rtol=0, atol=1e-3)


def test_virtual_node():
    g = synthetic_molhiv(1, seed=1)[0]
    vg = add_virtual_node(g)
    assert vg.num_nodes == g.num_nodes + 1
    assert vg.num_edges == g.num_edges + 2 * g.num_nodes
    assert np.all(vg.node_feat[-1] == 0)
    assert np.all(vg.edge_attr[g.num_edges :] == 0)
    # Star edges alternate (nd, N), (N, nd) — GIN-VN/src/host_load.cc:137-141.
    star = vg.edge_index[g.num_edges :]
    assert np.all(star[0::2, 1] == g.num_nodes)
    assert np.all(star[1::2, 0] == g.num_nodes)


def test_self_loops():
    g = synthetic_molhiv(1, seed=2)[0]
    sg = add_self_loops(g)
    assert sg.num_edges == g.num_edges + g.num_nodes
    assert np.all(sg.edge_index[: g.num_nodes, 0] == sg.edge_index[: g.num_nodes, 1])


def test_laplacian_eigen_orthonormal():
    g = laplacian_eigenvectors(synthetic_molhiv(1, seed=3)[0])
    assert g.node_eigen.shape == (g.num_nodes, 4)
    # Columns are eigenvectors of a symmetric matrix: orthonormal.
    gram = g.node_eigen.T @ g.node_eigen
    assert_allclose(gram, np.eye(4), rtol=0, atol=1e-4)


def test_packing_invariants(graphs16):
    packed = pack_graphs(graphs16[:8], 1024, 4096, 16)
    n_total = sum(g.num_nodes for g in graphs16[:8])
    e_total = sum(g.num_edges for g in graphs16[:8])
    assert packed.num_graphs == 8
    assert int(packed.n_node[:8].sum()) == n_total
    # Pad edges point at the pad node.
    assert np.all(packed.senders[e_total:] == 1024)
    assert np.all(packed.receivers[e_total:] == 1024)
    # Pad nodes belong to the pad graph.
    assert np.all(packed.node_graph[n_total:] == 16)
    # Node counts: pad graph owns all pad node slots.
    assert int(packed.n_node.sum()) == 1024 + 1


def test_pack_dataset_streams(graphs16):
    buckets = list(pack_dataset(graphs16, 128, 512, 8))
    assert sum(b.num_graphs for b in buckets) == 16
    for b in buckets:
        assert b.node_feat.shape == (129, 9)


def test_pack_overflow_raises():
    g = synthetic_molhiv(1, seed=4)[0]
    with pytest.raises(ValueError):
        pack_graphs([g], node_capacity=2, edge_capacity=4096, graph_capacity=4)


def test_fixed_spec_grid():
    spec = AP_FIXED_16_6
    assert spec.frac_bits == 10
    assert spec.epsilon == 1 / 1024
    assert spec.max_val == pytest.approx(31.9990234375)
    x = np.array([0.1, -0.1, 100.0, -100.0, 31.9990234375])
    q = spec.quantize_np(x)
    # truncation toward -inf
    assert q[0] == pytest.approx(np.floor(0.1 * 1024) / 1024)
    assert q[1] == pytest.approx(np.floor(-0.1 * 1024) / 1024)
    # saturation
    assert q[2] == spec.max_val and q[3] == spec.min_val
    assert q[4] == spec.max_val

    # jax path agrees with numpy path
    import jax.numpy as jnp

    qj = np.asarray(spec.quantize(jnp.asarray(x, jnp.float32)))
    assert_allclose(q, qj, rtol=0, atol=0)

    assert AP_FIXED_16_3.epsilon == 1 / 8192
    assert AP_FIXED_16_3.max_val == pytest.approx(4 - 1 / 8192)


def test_ogb_converter_roundtrip(tmp_path):
    """OGB raw CSVs -> reference layout + labels -> accuracy pipeline."""
    import numpy as np

    from flowgnn_tpu.core import io as gio
    from flowgnn_tpu.core import ogb as ogb_io
    from flowgnn_tpu.core.synthetic import synthetic_molhiv

    graphs = synthetic_molhiv(6, seed=1)
    raw = tmp_path / "raw"
    raw.mkdir()
    # Write the OGB raw layout from the synthetic graphs.
    with open(raw / "num-node-list.csv", "w") as f:
        f.writelines(f"{g.num_nodes}\n" for g in graphs)
    with open(raw / "num-edge-list.csv", "w") as f:
        f.writelines(f"{g.num_edges}\n" for g in graphs)
    with open(raw / "node-feat.csv", "w") as f:
        for g in graphs:
            f.writelines(",".join(map(str, r)) + "\n" for r in g.node_feat)
    with open(raw / "edge.csv", "w") as f:
        for g in graphs:
            f.writelines(f"{u},{v}\n" for u, v in g.edge_index)
    with open(raw / "edge-feat.csv", "w") as f:
        for g in graphs:
            f.writelines(",".join(map(str, r)) + "\n" for r in g.edge_attr)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, len(graphs))
    with open(raw / "graph-label.csv", "w") as f:
        f.writelines(f"{x}\n" for x in labels)

    out = tmp_path / "ds"
    n = ogb_io.convert_ogb(str(raw), str(out))
    assert n == 6
    back = list(gio.read_dataset(str(out)))
    for g0, g1 in zip(graphs, back):
        np.testing.assert_array_equal(g0.node_feat, g1.node_feat)
        np.testing.assert_array_equal(g0.edge_index, g1.edge_index)
        np.testing.assert_array_equal(g0.edge_attr, g1.edge_attr)
    lab = ogb_io.load_labels(str(out))
    np.testing.assert_array_equal(lab.ravel(), labels)


def test_accuracy_cli_on_converted_dataset(tmp_path):
    """One-command accuracy path: labelled dataset -> ROC-AUC number."""
    import json

    import numpy as np

    from flowgnn_tpu.cli import run_accuracy
    from flowgnn_tpu.core import io as gio
    from flowgnn_tpu.core.numerics import FLOAT32
    from flowgnn_tpu.core.synthetic import synthetic_molhiv

    graphs = synthetic_molhiv(8, seed=2)
    gio.write_dataset(str(tmp_path), graphs)
    rng = np.random.default_rng(1)
    np.savetxt(tmp_path / "labels.csv", rng.integers(0, 2, (8, 1)),
               delimiter=",")
    r = run_accuracy("gin", str(tmp_path), FLOAT32)
    assert r["metric"] == "rocauc"
    assert 0.0 <= r["value"] <= 1.0 or np.isnan(r["value"])
    assert r["num_graphs"] == 8


def test_auto_edge_capacity_fills_buckets():
    """A dense stream (e.g. VN stars ~4 edges/node) must fit one
    node-capacity bucket — the fixed 3x cap regression guard."""
    from flowgnn_tpu.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu.core.synthetic import synthetic_molhiv
    from flowgnn_tpu.models import registry

    spec = registry.get("gin-vn")
    graphs = registry.apply_transforms(spec, synthetic_molhiv(128, seed=3))
    node_cap = 4096
    cap = auto_edge_capacity(graphs, node_cap)
    assert cap % 1024 == 0
    density = sum(g.num_edges for g in graphs) / sum(
        g.num_nodes for g in graphs
    )
    assert cap >= node_cap * density  # headroom holds
    buckets = list(pack_dataset(graphs, node_cap, cap, 1024))
    # Every non-final bucket is node-bound (>=85% full), not edge-bound.
    for b in buckets[:-1]:
        assert int(b.n_node[:-1].sum()) >= 0.85 * node_cap
