"""Weight-set streaming (reload_weights parity) tests."""

import numpy as np
import pytest

from conftest import assert_allclose, seeded_params
from flowgnn_tpu.core.numerics import FLOAT32
from flowgnn_tpu.models import registry
from flowgnn_tpu.runtime.stream import InferenceStream


@pytest.fixture(scope="module")
def gin_param_sets():
    p0 = seeded_params("gin")
    p1 = {k: v * 0.5 if v.dtype.kind == "f" else v for k, v in p0.items()}
    return [p0, p1]


def test_stream_interleaved_weight_sets(gin_param_sets, graphs16):
    stream = InferenceStream("gin", gin_param_sets, FLOAT32,
                             node_capacity=512, edge_capacity=2048,
                             graph_capacity=8)
    # Interleave weight sets mid-stream: A A B B A ...
    sets = [0, 0, 1, 1, 0, 1, 0, 0]
    items = list(zip(graphs16[:8], sets))
    got = np.array(list(stream.run(items)))

    # Per-set reference: run each set's graphs alone.
    for s in (0, 1):
        only = [(g, s) for g, sid in items if sid == s for g in [g]]
        want = np.array(list(stream.run(only)))
        mask = np.array(sets) == s
        assert_allclose(got[mask], want, rtol=1e-6, atol=1e-6, msg=f"set {s}")

    # The two weight sets genuinely give different outputs.
    assert not np.allclose(got[:2], got[2:4])


def test_stream_order_preserved(gin_param_sets, graphs16):
    stream = InferenceStream("gin", gin_param_sets, FLOAT32,
                             node_capacity=128, edge_capacity=512,
                             graph_capacity=2)  # forces many flushes
    items = [(g, 0) for g in graphs16[:6]]
    got = np.array(list(stream.run(items)))
    big = InferenceStream("gin", gin_param_sets, FLOAT32)
    want = np.array(list(big.run(items)))
    assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_stream_bad_set_raises(gin_param_sets, graphs16):
    stream = InferenceStream("gin", gin_param_sets, FLOAT32)
    with pytest.raises(ValueError):
        list(stream.run([(graphs16[0], 7)]))


@pytest.mark.parametrize("name", ["gin", "gin-vn", "gat", "dgn"])
def test_stream_matches_plain_forward(name, graphs16):
    """The stream packs each bucket (natively where the graphs carry no
    eigen/VN payload, else in NumPy), narrows the categorical features to
    int8, and must predict what the jitted forward predicts on the same
    graphs packed directly."""
    import jax

    from flowgnn_tpu.core.graphs import pack_graphs
    from flowgnn_tpu.models.base import as_batch, prepare_params

    spec = registry.get(name)
    params = seeded_params(name)
    caps = dict(node_capacity=512, edge_capacity=2048, graph_capacity=16)
    stream = InferenceStream(name, [params], FLOAT32, **caps)
    got = np.array(list(stream.run([(g, 0) for g in graphs16[:8]])))
    tg = registry.apply_transforms(spec, graphs16[:8])
    want = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))(
        prepare_params(params, FLOAT32),
        as_batch(pack_graphs(tg, with_eigen=spec.needs_eigen, **caps)),
    )
    assert_allclose(got, np.asarray(want)[:8, 0], rtol=1e-5, atol=1e-5)


def test_stream_pipelined_matches_sequential(gin_param_sets, graphs16):
    """run_pipelined (pack bucket i+1 while the device runs bucket i,
    VERDICT r4 #4) must yield the SAME predictions in the SAME order as
    the sequential run, across weight-set flips and bucket boundaries."""
    stream = InferenceStream("gin", gin_param_sets, FLOAT32,
                             node_capacity=512, edge_capacity=2048,
                             graph_capacity=4)  # several buckets
    sets = [0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0, 1, 0]
    items = list(zip(graphs16, sets))
    want = np.array(list(stream.run(items)))
    got = np.array(list(stream.run_pipelined(items, depth=2)))
    assert got.shape == (16,)
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)
