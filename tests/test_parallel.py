"""Multi-device == single-device equivalence on the fake 8-CPU mesh.

The framework's substitute for multi-host hardware testing (SURVEY.md §4):
identical results from (a) one device, (b) 4-way data parallel, (c) 2×4
data×edge sharding with collective message completion over the device
interconnect.
"""

import jax
import numpy as np
import pytest

from conftest import assert_allclose, seeded_params
from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.core.numerics import FLOAT32
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from flowgnn_tpu.parallel.inference import sharded_forward, stack_buckets
from flowgnn_tpu.parallel.mesh import make_mesh

CAPS = dict(node_capacity=512, edge_capacity=2048, graph_capacity=16)


@pytest.mark.parametrize("name", ["gin", "gcn", "gat", "pna", "dgn"])
@pytest.mark.parametrize("data,edge", [(4, 1), (2, 4), (1, 8)])
def test_sharded_equals_single(name, data, edge, graphs16):
    if len(jax.devices()) < data * edge:
        pytest.skip("needs 8 fake devices")
    spec = registry.get(name)
    jparams = prepare_params(seeded_params(name), FLOAT32)
    tg = registry.apply_transforms(spec, graphs16)

    # data buckets of 4 graphs each (replicate buckets if data < 4).
    per = max(1, len(tg) // max(data, 1))
    buckets = [
        pack_graphs(tg[i * per : (i + 1) * per], with_eigen=spec.needs_eigen, **CAPS)
        for i in range(data)
    ]
    stacked = stack_buckets(buckets)

    mesh = make_mesh(data=data, edge=edge)
    fwd = sharded_forward(spec.forward, mesh, FLOAT32)
    sharded_out = np.asarray(fwd(jparams, stacked))

    # Single-device reference for each bucket.
    single = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))
    for i, b in enumerate(buckets):
        expected = np.asarray(single(jparams, as_batch(b)))
        got = sharded_out[i]
        k = b.num_graphs
        assert_allclose(got[:k], expected[:k], rtol=1e-5, atol=1e-5,
                        msg=f"{name} bucket {i} mesh {data}x{edge}")
