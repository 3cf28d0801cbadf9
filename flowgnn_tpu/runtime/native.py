"""ctypes bindings for the native host runtime (runtime/packer.cc).

The shared library is built on first use with g++ -O3 into ``_build/`` next
to the source, named by a hash of ``packer.cc`` so that a library built from
other source (or copied in from another machine) is never loaded. If the
toolchain is unavailable the callers fall back to the NumPy packer in
core/graphs.py (same layout, same results — test_runtime.py checks byte
equality).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from ..core.features import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from ..core.graphs import Graph, PackedGraphs

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "packer.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i32 = ctypes.c_int32


def _as_i32p(arr: Optional[np.ndarray]):
    if arr is None:
        return None
    assert arr.dtype == np.int32 and arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(_i32p)


def library_path() -> str:
    """Path of the library built from the current ``packer.cc``."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libfgpacker-{digest}.so")


def _build(path: str) -> bool:
    """Compile packer.cc to ``path`` (atomically: concurrent builders each
    write a private temp file and rename it into place)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native packer; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        lib = ctypes.CDLL(path)
        lib.fg_pack_bucket.restype = _i32
        lib.fg_pack_bucket.argtypes = (
            [_i32p] * 5 + [_i32] * 4 + [_i32p] * 7
        )
        lib.fg_read_graph.restype = _i32
        lib.fg_read_graph.argtypes = [ctypes.c_char_p, _i32] + [_i32p] * 4
        _lib = lib
        return _lib


def pack_bucket_native(
    graphs: list[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
) -> tuple[PackedGraphs, int]:
    """Pack as many of ``graphs`` as fit; returns (bucket, graphs_consumed)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native packer unavailable")

    node_feat = np.concatenate([g.node_feat for g in graphs]).astype(np.int32)
    edge_index = np.concatenate([g.edge_index for g in graphs]).astype(np.int32)
    has_attr = graphs[0].edge_attr is not None
    edge_attr = (
        np.concatenate([g.edge_attr for g in graphs]).astype(np.int32)
        if has_attr
        else None
    )
    n_nodes = np.array([g.num_nodes for g in graphs], np.int32)
    n_edges = np.array([g.num_edges for g in graphs], np.int32)

    out_node_feat = np.empty((node_capacity + 1, NUM_ATOM_FEATURES), np.int32)
    out_node_graph = np.empty(node_capacity + 1, np.int32)
    out_senders = np.empty(edge_capacity, np.int32)
    out_receivers = np.empty(edge_capacity, np.int32)
    out_edge_attr = np.empty((edge_capacity, NUM_BOND_FEATURES), np.int32)
    out_n_node = np.empty(graph_capacity + 1, np.int32)
    out_n_edge = np.empty(graph_capacity + 1, np.int32)

    consumed = lib.fg_pack_bucket(
        _as_i32p(node_feat), _as_i32p(edge_index), _as_i32p(edge_attr),
        _as_i32p(n_nodes), _as_i32p(n_edges), len(graphs),
        node_capacity, edge_capacity, graph_capacity,
        _as_i32p(out_node_feat), _as_i32p(out_node_graph),
        _as_i32p(out_senders), _as_i32p(out_receivers),
        _as_i32p(out_edge_attr), _as_i32p(out_n_node),
        _as_i32p(out_n_edge),
    )
    if consumed < 0:
        raise ValueError("first graph exceeds bucket capacity")
    packed = PackedGraphs(
        out_node_feat, out_node_graph, out_senders, out_receivers,
        out_edge_attr, out_n_node, out_n_edge, None,
    )
    return packed, int(consumed)


def read_graph_native(dataset_dir: str, index: int, with_attr: bool = True) -> Graph:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native reader unavailable")
    counts = np.zeros(2, np.int32)
    rc = lib.fg_read_graph(
        dataset_dir.encode(), index, _as_i32p(counts), None, None, None
    )
    if rc != 0:
        raise FileNotFoundError(f"graph {index} in {dataset_dir}: rc={rc}")
    n, e = int(counts[0]), int(counts[1])
    node_feat = np.empty((n, NUM_ATOM_FEATURES), np.int32)
    edge_index = np.empty((e, 2), np.int32)
    edge_attr = np.empty((e, NUM_BOND_FEATURES), np.int32) if with_attr else None
    rc = lib.fg_read_graph(
        dataset_dir.encode(), index, _as_i32p(counts),
        _as_i32p(node_feat), _as_i32p(edge_index), _as_i32p(edge_attr),
    )
    if rc != 0:
        raise IOError(f"graph {index} read failed: rc={rc}")
    return Graph(node_feat, edge_index, edge_attr)


def pack_dataset_native(
    graphs: list[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
):
    """Greedy streaming packer over the native bucket packer."""
    i = 0
    while i < len(graphs):
        bucket, consumed = pack_bucket_native(
            graphs[i:], node_capacity, edge_capacity, graph_capacity
        )
        yield bucket
        i += consumed
