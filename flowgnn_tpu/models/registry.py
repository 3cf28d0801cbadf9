"""Model registry: name → (forward fn, graph transforms, batch requirements).

The capability matrix mirrors run_experiments.sh:52's model list. Host-side
graph transforms stand in for what the reference does in host code (GIN-VN's
virtual node) or on-device at load time (GAT's self edges).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

from ..core import graphs as G
from ..core.numerics import AP_FIXED_16_3, AP_FIXED_16_6, FixedSpec
from ..params import loaders, seeded
from . import dgn, gat, gcn, gin, pna


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    forward: Callable
    loader: Callable  # reference weight binaries → param pytree
    init: Callable  # seed → param pytree of the loader's shapes
    dim: int
    num_layers: int
    transforms: tuple[Callable, ...] = ()
    needs_edge_attr: bool = True
    needs_eigen: bool = False
    fixed_spec: FixedSpec = AP_FIXED_16_6
    reference_dir: str = ""  # subdirectory name in the reference tree


MODELS: dict[str, ModelSpec] = {
    "gin": ModelSpec(
        "gin", gin.forward, loaders.load_gin, seeded.init_gin, dim=100,
        num_layers=5, reference_dir="GIN",
    ),
    "gin-vn": ModelSpec(
        # Production transform = the ANALYTIC virtual node (star messages
        # as per-graph pool + broadcast; see models/gin.py). Reference-
        # ordered semantics (oracles, golden, fixed-exact replays) use
        # G.add_virtual_node — the materialized star — directly.
        "gin-vn", gin.forward, loaders.load_gin, seeded.init_gin, dim=100,
        num_layers=5, transforms=(G.add_virtual_node_analytic,),
        reference_dir="GIN-VN",
    ),
    "gcn": ModelSpec(
        "gcn", gcn.forward, loaders.load_gcn, seeded.init_gcn, dim=100,
        num_layers=5, reference_dir="GCN",
    ),
    "gat": ModelSpec(
        "gat", gat.forward, loaders.load_gat, seeded.init_gat, dim=16,
        num_layers=5, transforms=(G.add_self_loops,), needs_edge_attr=False,
        reference_dir="GAT",
    ),
    "pna": ModelSpec(
        "pna", pna.forward, loaders.load_pna, seeded.init_pna, dim=80,
        num_layers=4, needs_edge_attr=False, reference_dir="PNA",
    ),
    "dgn": ModelSpec(
        "dgn", dgn.forward, loaders.load_dgn, seeded.init_dgn, dim=100,
        num_layers=4, needs_edge_attr=False, needs_eigen=True,
        fixed_spec=AP_FIXED_16_3, reference_dir="DGN",
    ),
}


def get(name: str) -> ModelSpec:
    return MODELS[name]


def load_params(name: str, seed: int = 0, reference: Optional[str] = None) -> dict:
    """Float32 numpy param pytree for ``name``: seeded random weights at the
    published widths, or the reference's weight binaries when ``reference``
    names the reference tree's root directory."""
    spec = MODELS[name]
    if reference is None:
        return spec.init(seed)
    return spec.loader(os.path.join(reference, spec.reference_dir))


def apply_transforms(spec: ModelSpec, gs: Sequence[G.Graph]) -> list[G.Graph]:
    out = []
    for g in gs:
        if spec.needs_eigen and g.node_eigen is None:
            g = G.laplacian_eigenvectors(g)
        for t in spec.transforms:
            g = t(g)
        out.append(g)
    return out
