"""Seeded parameters (params/seeded.py) and the dot precision of the models.

The seeded initializers stand in for the reference's trained weight
binaries, so they must produce exactly the pytree each loader produces —
same keys, shapes, dtypes and zero padding — deterministically by seed, and
keep every model's outputs finite and O(1).
"""

import jax
import numpy as np
import pytest

from flowgnn_tpu.core.features import ATOM_FEATURE_DIMS
from flowgnn_tpu.core.graphs import pack_graphs
from flowgnn_tpu.core.numerics import BF16, FLOAT32, Precision
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from flowgnn_tpu.params import loaders, seeded

ALL_MODELS = ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"]


def _loader_pytree(name, monkeypatch):
    """What the loader returns, with every weight file read as zeros — its
    shapes, dtypes and padding without the reference binaries."""
    monkeypatch.setattr(
        loaders, "_read",
        lambda path, count, offset_floats=0: np.zeros(count, np.float32),
    )
    return registry.get(name).loader("unused")


@pytest.mark.parametrize("name", ALL_MODELS)
def test_seeded_matches_loader_pytree(name, monkeypatch):
    want = _loader_pytree(name, monkeypatch)
    got = registry.load_params(name, seed=0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    if name == "pna":
        assert got["avg_deg"] == want["avg_deg"]


def test_seeded_zero_padding_as_loaders_pad():
    gat = seeded.init_gat(0)
    for w in (gat["proj_w"], gat["skip_w"]):
        layer0 = w[0].copy()
        assert np.any(layer0[:, :, 0, :9] != 0)
        layer0[:, :, 0, :9] = 0
        assert not np.any(layer0)  # only [:, :, 0, :9] of layer 0 is used
    tables = seeded.init_dgn(0)["atom_tables"]
    for i, vocab in enumerate(ATOM_FEATURE_DIMS):
        assert not np.any(tables[i, vocab:])
        assert np.any(tables[i, :vocab])
    gcn = seeded.init_gcn(0)
    assert np.all(gcn["bn_var"] > 0)
    assert np.all(seeded.init_gin(0)["eps"] != 0)


@pytest.mark.parametrize("name", ALL_MODELS)
def test_seeded_deterministic_by_seed(name):
    a, b, c = (registry.load_params(name, s) for s in (0, 0, 1))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a if a[k].size > 1)


def test_seeded_on_fixed_point_grid():
    """Every weight sits on the ap_fixed<16,6> grid, so fixed mode's weight
    snap leaves them unchanged."""
    for name in ALL_MODELS:
        for k, v in registry.load_params(name).items():
            if k == "avg_deg":
                continue  # the loader's exact constant
            scaled = v.astype(np.float64) * 1024
            np.testing.assert_array_equal(scaled, np.round(scaled), err_msg=k)


@pytest.mark.parametrize("name", ALL_MODELS)
def test_seeded_forward_finite_and_order_one(name, graphs16):
    spec = registry.get(name)
    tg = registry.apply_transforms(spec, graphs16)
    batch = as_batch(pack_graphs(tg, 1024, 4096, 32, with_eigen=spec.needs_eigen))
    out, inter = spec.forward(
        prepare_params(registry.load_params(name), FLOAT32), batch, FLOAT32,
        return_intermediates=True,
    )
    out = np.asarray(out)[:16]
    assert np.all(np.isfinite(out))
    assert np.abs(out).max() < 100
    real = int(batch["n_node"][:-1].sum())  # pad rows collect pad edges
    for h in inter["layers"]:
        h = np.asarray(h)[:real]
        assert np.all(np.isfinite(h)) and np.abs(h).mean() < 10


def _dot_precisions(name, prec, graphs):
    spec = registry.get(name)
    tg = registry.apply_transforms(spec, graphs)
    batch = as_batch(pack_graphs(tg, 512, 2048, 16, with_eigen=spec.needs_eigen))
    jp = prepare_params(registry.load_params(name), prec)
    jaxpr = jax.make_jaxpr(lambda p, b: spec.forward(p, b, prec))(jp, batch)
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(str(eqn.params["precision"]))
            for val in eqn.params.values():
                if hasattr(val, "jaxpr") and hasattr(val.jaxpr, "eqns"):
                    walk(val.jaxpr)

    walk(jaxpr.jaxpr)
    return found


@pytest.mark.parametrize("name", ALL_MODELS)
def test_f32_dots_run_at_highest_precision(name, graphs16):
    """FLOAT32 must not drop to TF32 on a GPU: every dot in the f32 jaxpr
    asks for HIGHEST. BF16 and the on-record default-dots variant keep the
    backend's default."""
    f32 = _dot_precisions(name, FLOAT32, graphs16[:4])
    assert f32 and all("HIGHEST" in p for p in f32), f32
    for prec in (BF16, Precision(default_dots=True)):
        assert not any("HIGHEST" in p for p in _dot_precisions(
            name, prec, graphs16[:4]))
