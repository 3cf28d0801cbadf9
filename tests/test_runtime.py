"""Native C++ packer vs NumPy packer: byte-identical buckets."""

import os

import numpy as np
import pytest

from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.core import io as gio
from flowgnn_tpu.runtime import native

CAPS = (512, 2048, 16)


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    if lib is None:
        pytest.skip("g++ unavailable")
    return lib


def test_native_pack_matches_numpy(lib, graphs16):
    want = pack_graphs(graphs16, *CAPS)
    got, consumed = native.pack_bucket_native(graphs16, *CAPS)
    assert consumed == 16
    for field in ("node_feat", "node_graph", "senders", "receivers",
                  "edge_attr", "n_node", "n_edge"):
        np.testing.assert_array_equal(
            getattr(got, field), getattr(want, field), err_msg=field
        )


def test_native_pack_partial(lib, graphs16):
    # Tiny bucket: should consume a prefix and report how many.
    got, consumed = native.pack_bucket_native(graphs16, 64, 256, 16)
    assert 1 <= consumed < 16
    want = pack_graphs(graphs16[:consumed], 64, 256, 16)
    np.testing.assert_array_equal(got.senders, want.senders)


def test_native_reader_roundtrip(lib, tmp_path, graphs16):
    gio.write_dataset(str(tmp_path), graphs16[:3])
    for i in range(1, 4):
        g = native.read_graph_native(str(tmp_path), i)
        np.testing.assert_array_equal(g.node_feat, graphs16[i - 1].node_feat)
        np.testing.assert_array_equal(g.edge_index, graphs16[i - 1].edge_index)
        np.testing.assert_array_equal(g.edge_attr, graphs16[i - 1].edge_attr)


def test_native_dataset_pack(lib, graphs16):
    buckets = list(native.pack_dataset_native(graphs16, 128, 512, 8))
    assert sum(int((b.n_node[:-1] > 0).sum()) for b in buckets) == 16


def test_native_library_keyed_by_source_hash(lib, tmp_path, monkeypatch):
    """The library's name carries a hash of packer.cc, so a library built
    from other source (or copied in from elsewhere) is never picked up, and
    it is built into the ignored _build/ directory."""
    path = native.library_path()
    assert os.path.dirname(path) == native._BUILD_DIR
    assert os.path.exists(path)
    src = tmp_path / "packer.cc"
    src.write_bytes(open(native._SRC, "rb").read() + b"\n// changed\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native.library_path() != path
