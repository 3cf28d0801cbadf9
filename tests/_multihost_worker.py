"""Worker process for tests/test_multihost.py — one host of a 2-host run.

Launched as ``python _multihost_worker.py <out_dir>`` with
FLOWGNN_COORDINATOR / FLOWGNN_NUM_PROCESSES / FLOWGNN_PROCESS_ID in the
environment (the multihost.initialize resolution path under test) and
XLA_FLAGS=--xla_force_host_platform_device_count=4 set pre-import.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from flowgnn_tpu.core.graphs import pack_graphs  # noqa: E402
from flowgnn_tpu.core.numerics import FLOAT32  # noqa: E402
from flowgnn_tpu.core.synthetic import synthetic_molhiv  # noqa: E402
from flowgnn_tpu.models import registry  # noqa: E402
from flowgnn_tpu.models.base import prepare_params  # noqa: E402
from flowgnn_tpu.parallel import multihost  # noqa: E402
from flowgnn_tpu.parallel.halo import build_halo_batch  # noqa: E402
from flowgnn_tpu.parallel.inference import (  # noqa: E402
    halo_forward, stack_halo_buckets,
)
from flowgnn_tpu.parallel.mesh import make_mesh  # noqa: E402


def main() -> None:
    out_dir = sys.argv[1]
    assert multihost.initialize(), "expected multi-process env vars"
    assert jax.process_count() == 2

    spec = registry.get("gin")
    params = prepare_params(registry.load_params("gin"), FLOAT32)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(16, seed=11))
    caps = dict(node_capacity=256, edge_capacity=1024, graph_capacity=4)
    buckets = [pack_graphs(graphs[4 * i : 4 * i + 4], **caps) for i in range(4)]

    # Each host: 2 of the 4 buckets, stacked over a LOCAL data=2 x edge=2
    # mesh of its own 4 CPU devices — per-layer collectives never touch DCN.
    groups, real = multihost.shard_stream(buckets, local_data=2)
    assert len(groups) == 1 and len(groups[0]) == 2 and real == [2]
    mesh = make_mesh(data=2, edge=2, devices=jax.local_devices())
    stacked = stack_halo_buckets(
        [build_halo_batch(b, k=2, window=32, edge_slack=8.0) for b in groups[0]]
    )
    out = halo_forward(spec.forward, mesh, FLOAT32)(params, stacked)

    gathered = multihost.gather_results(np.asarray(out))  # [2 hosts, 2, G+1, 1]
    if jax.process_index() == 0:
        np.save(os.path.join(out_dir, "gathered.npy"), gathered)


if __name__ == "__main__":
    main()
