"""Seeded random parameters at each model's published widths.

Every initializer returns exactly the pytree its reference loader in
``params/loaders.py`` returns (same keys, shapes, dtypes and zero padding),
so the models, oracles and benchmarks run without the reference weight
binaries. Weights are normal draws scaled by fan-in so that activations stay
O(1) through every layer; the values are random, so predictions only mean
anything as a comparison between two implementations of the same math.

Every drawn value is rounded to the ap_fixed<16,6> grid (multiples of
2^-10, which ap_fixed<16,3> also holds exactly), the grid the FPGA stores
its weights on. Fan-in-scaled weights are only a few grid steps wide, so
off-grid draws would make the fixed-point modes' truncating weight snap
(core/numerics.py) a systematic bias of half a step per weight instead of
the activation-quantization envelope those modes are meant to show.
"""

from __future__ import annotations

import numpy as np

from ..core.features import (
    ATOM_FEATURE_DIMS,
    ATOM_FEATURE_TOTAL,
    BOND_FEATURE_TOTAL,
    NUM_ATOM_FEATURES,
    NUM_BOND_FEATURES,
)

F32 = np.float32
GRID = 2.0**-10  # ap_fixed<16,6> step
PNA_AVG_DEG = 6.885701656341553  # the loader's constant (loaders.load_pna)


def _grid(x) -> np.ndarray:
    return (np.round(np.asarray(x) / GRID) * GRID).astype(F32)


def _normal(rng, shape, fan_in: float, gain: float = 1.0) -> np.ndarray:
    return _grid(rng.standard_normal(shape) * gain / np.sqrt(fan_in))


def _uniform(rng, lo: float, hi: float, shape) -> np.ndarray:
    return _grid(rng.uniform(lo, hi, shape))


def init_gin(seed: int = 0, dim: int = 100) -> dict:
    """GIN / GIN-VN: dim 100, 5 layers, MLP dim→2·dim→dim (loaders.load_gin)."""
    L, H = 5, 2 * dim
    rng = np.random.default_rng(seed)
    return {
        "node_embedding": _normal(rng, (ATOM_FEATURE_TOTAL, dim), NUM_ATOM_FEATURES),
        "edge_embedding": _normal(rng, (L, BOND_FEATURE_TOTAL, dim), NUM_BOND_FEATURES),
        # Nonzero so that the trained-ε mode (fpga_eps=False) differs.
        "eps": _uniform(rng, 0.05, 0.3, L),
        "mlp1_w": _normal(rng, (L, H, dim), dim),
        "mlp1_b": _normal(rng, (L, H), 1, 0.1),
        "mlp2_w": _normal(rng, (L, dim, H), H, 0.35),
        "mlp2_b": _normal(rng, (L, dim), 1, 0.1),
        "pred_w": _normal(rng, (1, dim), dim),
        "pred_b": _normal(rng, (1,), 1, 0.1),
    }


def init_gcn(seed: int = 0, dim: int = 100) -> dict:
    """GCN: dim 100, 5 layers, batch-norm statistics with bn_var > 0."""
    L = 5
    rng = np.random.default_rng(seed)
    return {
        "node_embedding": _normal(rng, (ATOM_FEATURE_TOTAL, dim), NUM_ATOM_FEATURES),
        "edge_embedding": _normal(rng, (L, BOND_FEATURE_TOTAL, dim), NUM_BOND_FEATURES),
        "conv_w": _normal(rng, (L, dim, dim), dim),
        "conv_b": _normal(rng, (L, dim), 1, 0.1),
        "root_emb": _normal(rng, (L, dim), 1, 0.5),
        "bn_weight": _uniform(rng, 0.5, 1.5, (L, dim)),
        "bn_bias": _normal(rng, (L, dim), 1, 0.1),
        "bn_mean": _normal(rng, (L, dim), 1, 0.2),
        "bn_var": _uniform(rng, 0.5, 2.0, (L, dim)),
        "pred_w": _normal(rng, (1, dim), dim),
        "pred_b": _normal(rng, (1,), 1, 0.1),
    }


def init_gat(seed: int = 0, dim: int = 16, heads: int = 4, layers: int = 5) -> dict:
    """GAT: 4 heads × 16, 5 layers. Layer 0 projects the 9 raw integer
    features from head-0 slots, so only ``[0, :, :, 0, :9]`` is nonzero,
    as ``load_gat`` pads it; each column is scaled by its feature's
    vocabulary so the raw values (up to 118) give O(1) projections."""
    rng = np.random.default_rng(seed)
    hd = heads * dim
    shape = (layers, heads, dim, heads, dim)
    proj = np.zeros(shape, F32)
    skip = np.zeros(shape, F32)
    vocab = np.asarray(ATOM_FEATURE_DIMS, F32)
    for w in (proj, skip):
        w[0, :, :, 0, :NUM_ATOM_FEATURES] = _grid(_normal(
            rng, (heads, dim, NUM_ATOM_FEATURES), NUM_ATOM_FEATURES
        ) / vocab)
        w[1:] = _normal(rng, (layers - 1,) + shape[1:], hd)
    return {
        "proj_w": proj,
        "skip_w": skip,
        "a_src": _normal(rng, (layers, heads, dim), dim),
        "a_tgt": _normal(rng, (layers, heads, dim), dim),
        "pred_w": _normal(rng, (1, dim), dim),
        "pred_b": _normal(rng, (1,), 1, 0.1),
    }


def init_pna(seed: int = 0, dim: int = 80) -> dict:
    """PNA: dim 80, 4 layers, one [dim, 3 scalers, 4 aggregators, dim]
    tower per layer, readout MLP dim→40→20→1, the loader's avg_deg."""
    L = 4
    rng = np.random.default_rng(seed)
    return {
        "node_embedding": _normal(rng, (ATOM_FEATURE_TOTAL, dim), NUM_ATOM_FEATURES),
        "conv_w": _normal(rng, (L, dim, 3, 4, dim), 12 * dim, 0.3),
        "conv_b": _normal(rng, (L, dim), 1, 0.1),
        "mlp1_w": _normal(rng, (40, dim), dim),
        "mlp1_b": _normal(rng, (40,), 1, 0.1),
        "mlp2_w": _normal(rng, (20, 40), 40),
        "mlp2_b": _normal(rng, (20,), 1, 0.1),
        "mlp3_w": _normal(rng, (1, 20), 20),
        "mlp3_b": _normal(rng, (1,), 1, 0.1),
        "avg_deg": np.asarray(PNA_AVG_DEG, F32),
    }


def init_dgn(seed: int = 0, dim: int = 100) -> dict:
    """DGN: dim 100, 4 layers, 9 atom tables zero-padded past their
    vocabularies to the device's [9, 119, dim] array. Scaled smaller than
    the others: its ap_fixed<16,3> mode saturates at ±4."""
    L = 4
    rng = np.random.default_rng(seed)
    tables = np.zeros((NUM_ATOM_FEATURES, max(ATOM_FEATURE_DIMS), dim), F32)
    for i, vocab in enumerate(ATOM_FEATURE_DIMS):
        tables[i, :vocab] = _normal(rng, (vocab, dim), NUM_ATOM_FEATURES, 0.3)
    return {
        "atom_tables": tables,
        "posttrans_w": _normal(rng, (L, dim, 2, dim), 2 * dim, 0.3),
        "posttrans_b": _normal(rng, (L, dim), 1, 0.05),
        "mlp1_w": _normal(rng, (50, dim), dim),
        "mlp1_b": _normal(rng, (50,), 1, 0.1),
        "mlp2_w": _normal(rng, (25, 50), 50),
        "mlp2_b": _normal(rng, (25,), 1, 0.1),
        "mlp3_w": _normal(rng, (1, 25), 25),
        "mlp3_b": _normal(rng, (1,), 1, 0.1),
    }


INITS = {
    "gin": init_gin,
    "gin-vn": init_gin,  # same weights as GIN; the graph transform differs
    "gcn": init_gcn,
    "gat": init_gat,
    "pna": init_pna,
    "dgn": init_dgn,
}
