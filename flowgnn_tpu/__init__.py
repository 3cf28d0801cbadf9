"""flowgnn_tpu — a GNN message-passing inference framework in JAX.

A JAX/XLA implementation of the capabilities of
sharc-lab/FlowGNN (the Vitis HLS FPGA dataflow accelerator): batched inference
for GIN, GIN-VN, GCN, GAT, PNA and DGN over OGB molecular graphs, validated
against independent f64 NumPy oracles.
"""

__version__ = "0.1.0"

from .core.graphs import Graph, PackedGraphs, pack_dataset, pack_graphs  # noqa: F401
from .core.numerics import FIXED_16_3, FIXED_16_6, FLOAT32, Precision  # noqa: F401
from .models.registry import MODELS, get  # noqa: F401
