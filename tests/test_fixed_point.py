"""Fixed-point emulation mode tests (the reference's ap_fixed numerics).

The tolerance ladder (core/numerics.py): fixed mode reproduces the
reference's quantization envelope — weights snapped to the ap_fixed grid,
activations re-quantized at stage boundaries — without replaying the FPGA's
accumulation order.
"""

import jax
import numpy as np
import pytest

from conftest import seeded_params
from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.core.numerics import (
    AP_FIXED_16_3,
    AP_FIXED_16_6,
    FLOAT32,
    Precision,
)
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params

CAPS = dict(node_capacity=512, edge_capacity=2048, graph_capacity=16)


def _run(name, graphs, prec):
    spec = registry.get(name)
    params = seeded_params(name)
    tg = registry.apply_transforms(spec, graphs)
    packed = pack_graphs(tg, with_eigen=spec.needs_eigen, **CAPS)
    fwd = jax.jit(lambda p, b: spec.forward(p, b, prec))
    out = fwd(prepare_params(params, prec), as_batch(packed))
    return np.asarray(out)[: len(graphs), 0]


@pytest.mark.parametrize("name", ["gin", "gcn", "gat", "pna", "dgn"])
def test_fixed_mode_tracks_float(name, graphs16):
    """Fixed mode stays within the quantization-error envelope of float."""
    spec = registry.get(name)
    prec_fixed = Precision(fixed=spec.fixed_spec)
    a = _run(name, graphs16[:8], FLOAT32)
    b = _run(name, graphs16[:8], prec_fixed)
    assert np.all(np.isfinite(b))
    # Loose envelope: per-layer quantization at 2^-10 (2^-13 for DGN)
    # accumulates through 4-5 layers; outputs are O(1)-O(100). DGN's
    # ap_fixed<16,3> saturates at ±4 — synthetic random-feature graphs push
    # embeddings into saturation harder than trained molhiv data, so its
    # fixed mode legitimately clips (exactly as the FPGA would).
    scale = np.maximum(np.abs(a), 1.0)
    rel = np.abs(a - b) / scale
    limit = 0.6 if name == "dgn" else 0.15
    assert rel.max() < limit, (name, rel.max(), a, b)


def test_gin_vn_fixed_mode_saturates_on_grid(graphs16):
    """GIN-VN's fixed-mode rung: the float envelope claim does not apply.

    The virtual-node star (GIN-VN/src/host_load.cc:129-153) sums messages
    from every node into one accumulator; on synthetic random-feature
    graphs that sum overflows ap_fixed<16,6>'s ±32 range in layer 0, where
    the reference device WRAPS (AP_WRAP) — chaotic, order-dependent, and
    pinned bit-for-bit by test_golden.py::test_gin_vn_bit_exact_vs_
    reference_kernel via the per-PE wrap replay in fixed_exact.py. No
    vectorized emulation can "track float" through a wrapped accumulator,
    so this rung asserts what IS true of the emulation: saturating fixed
    mode stays finite, exactly on the value grid, in range, and
    deterministic.
    """
    spec = registry.get("gin-vn")
    fx = spec.fixed_spec
    a = _run("gin-vn", graphs16[:8], Precision(fixed=fx))
    b = _run("gin-vn", graphs16[:8], Precision(fixed=fx))
    np.testing.assert_array_equal(a, b)
    assert np.all(np.isfinite(a))
    scaled = a.astype(np.float64) * fx.scale
    np.testing.assert_array_equal(scaled, np.round(scaled))
    assert np.abs(a).max() <= fx.max_val + 1e-9


@pytest.mark.parametrize("name,spec_fx", [("gin", AP_FIXED_16_6), ("dgn", AP_FIXED_16_3)])
def test_fixed_outputs_on_grid(name, spec_fx, graphs16):
    """Every fixed-mode output lies exactly on the ap_fixed value grid."""
    out = _run(name, graphs16[:8], Precision(fixed=spec_fx))
    scaled = out.astype(np.float64) * spec_fx.scale
    np.testing.assert_array_equal(scaled, np.round(scaled))
    assert np.abs(out).max() <= spec_fx.max_val + 1e-9


def test_fixed_mode_deterministic(graphs16):
    a = _run("gin", graphs16[:4], Precision(fixed=AP_FIXED_16_6))
    b = _run("gin", graphs16[:4], Precision(fixed=AP_FIXED_16_6))
    np.testing.assert_array_equal(a, b)
