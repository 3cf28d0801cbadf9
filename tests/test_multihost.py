"""Multi-host DCN distribution (parallel/multihost.py) — SURVEY.md §7.6.

Spawns TWO real OS processes that form a ``jax.distributed`` CPU cluster
(4 fake devices each), deal the bucket stream between themselves, run the
halo-sharded step on their local data×edge meshes, and all-gather the
predictions — asserted equal to the single-process forward. This is the
same code path a multi-host GPU cluster runs (initialize → shard_stream →
local mesh → gather_results); only the backend differs.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

import jax

from conftest import seeded_params
from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.core.numerics import FLOAT32
from flowgnn_tpu.core.synthetic import synthetic_molhiv
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from flowgnn_tpu.parallel import multihost

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_single_process_noop():
    assert multihost.initialize() is False  # no env, no args → single process


def test_shard_stream_single_process_grouping():
    groups, real = multihost.shard_stream(list(range(5)), local_data=2)
    # Trailing partial group is PADDED (repeat last) and marked, not dropped.
    assert groups == [[0, 1], [2, 3], [4, 4]]
    assert real == [2, 2, 1]


def test_cli_multihost_two_processes_all_predictions(tmp_path):
    """VERDICT r2 #7: the DCN tier driven end-to-end from the CLI
    (`cli run --multihost`) across two real OS processes, with a bucket
    count that does NOT divide the per-host group size — the padded
    trailing group must be de-duplicated and EVERY graph accounted for in
    submission order, matching the single-process forward."""
    port = _free_port()
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "FLOWGNN_COORDINATOR": f"127.0.0.1:{port}",
        "FLOWGNN_NUM_PROCESSES": "2",
    }
    cmd = [
        sys.executable, "-m", "flowgnn_tpu.cli", "run",
        "--model", "gin", "--dataset", "synth", "--num-graphs", "20",
        "--multihost", "--edge-shards", "2", "--local-data", "2",
        "--node-cap", "255", "--edge-cap", "1024", "--graph-cap", "4",
        "--out", str(tmp_path), "--f32",
    ]
    procs = [
        subprocess.Popen(
            cmd, env={**env_base, "FLOWGNN_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    # 20 graphs at graph-cap 4 → 5 buckets: host 0 gets 3 (one PADDED
    # group), host 1 gets 2 — the non-divisible case under test.
    import json as _json

    meta = next(
        _json.loads(l)
        for l in reversed(outs[0].strip().splitlines())
        if l.startswith("{")
    )
    assert meta["buckets"] == 5 and meta["hosts"] == 2

    lines = (tmp_path / "gin_output.txt").read_text().strip().splitlines()
    assert len(lines) == 20  # every prediction accounted for, in order
    got = np.array([float(l.split(": ")[1]) for l in lines])

    # Ground truth: single-process plain forward over the same packing.
    from flowgnn_tpu.core.graphs import pack_dataset

    spec = registry.get("gin")
    params = prepare_params(seeded_params("gin"), FLOAT32)
    from flowgnn_tpu.core.graphs import auto_edge_capacity

    graphs = registry.apply_transforms(spec, synthetic_molhiv(20, seed=0))
    buckets = list(pack_dataset(
        graphs, node_capacity=255,
        edge_capacity=max(1024, auto_edge_capacity(graphs, 255)),
        graph_capacity=4,
    ))
    assert len(buckets) == 5
    fwd = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))
    want = np.concatenate(
        [np.asarray(fwd(params, as_batch(b)))[: b.num_graphs, 0]
         for b in buckets]
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_two_process_cluster_matches_single(tmp_path):
    port = _free_port()
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "FLOWGNN_COORDINATOR": f"127.0.0.1:{port}",
        "FLOWGNN_NUM_PROCESSES": "2",
    }
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(tmp_path)],
            env={**env_base, "FLOWGNN_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    gathered = np.load(tmp_path / "gathered.npy")  # [2 hosts, 2 buckets, G+1, 1]
    assert gathered.shape[:2] == (2, 2)

    # Ground truth: plain single-device forward per bucket, in the dealt
    # order (round-robin: host 0 → buckets 0,2; host 1 → buckets 1,3).
    spec = registry.get("gin")
    params = prepare_params(seeded_params("gin"), FLOAT32)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(16, seed=11))
    caps = dict(node_capacity=256, edge_capacity=1024, graph_capacity=4)
    buckets = [pack_graphs(graphs[4 * i : 4 * i + 4], **caps) for i in range(4)]
    fwd = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))
    for host in range(2):
        for row in range(2):
            b = buckets[2 * row + host]
            ref = np.asarray(fwd(params, as_batch(b)))
            np.testing.assert_allclose(  # pad-graph row is garbage by design
                gathered[host, row, : b.num_graphs],
                ref[: b.num_graphs], rtol=2e-5, atol=2e-5,
            )
