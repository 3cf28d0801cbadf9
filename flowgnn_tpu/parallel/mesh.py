"""Device mesh helpers.

The reference's only parallel hardware is intra-chip dataflow (SURVEY.md
§2.4). The analog of scaling its workload across accelerators is a 2-axis
mesh:

  * ``data``  — whole packed buckets per chip (throughput scaling; the
    moral equivalent of running multiple U50s side by side),
  * ``edge``  — the batched graph's edge set partitioned across chips with
    node messages combined over the device interconnect (the EDGE_PARALLEL
    mapping; grows the
    maximum batch/graph size past one chip, the way the reference is bounded
    by MAX_NODE/MAX_EDGE — GIN/src/dcl.h:17-18).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(data: int = 1, edge: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if data * edge > len(devices):
        raise ValueError(f"mesh {data}x{edge} needs {data * edge} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[: data * edge]).reshape(data, edge)
    return Mesh(arr, ("data", "edge"))
