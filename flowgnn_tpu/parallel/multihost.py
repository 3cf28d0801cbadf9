"""Multi-host (multi-process) distribution over DCN — SURVEY.md §7.6.

The reference is a single-card host program; its scaling story ends at one
Alveo U50. The scale-out here has TWO tiers:

  * intra-host (device interconnect, e.g. NVLink): the ('data', 'edge')
    mesh of parallel/mesh.py — shard_map + collectives, built from whatever
    devices the process sees;
  * inter-host (DCN): multiple processes, each driving its local chips,
    coordinated through ``jax.distributed``. Graph STREAMS are distributed
    at bucket granularity across hosts (molecule inference is embarrassingly
    data-parallel above one bucket — the moral equivalent of running N
    reference hosts side by side), while each bucket still uses the local
    mesh's edge axis for graphs too big for one chip.

``initialize()`` wires a process into the cluster (no-op single-process),
``global_mesh()`` builds the data×edge mesh over ALL cluster devices with
hosts laid out along the data axis (edge-axis collectives then ride the
device interconnect, never DCN — the scaling-book rule), ``shard_stream()``
deals buckets to this process, and ``gather_results()`` reassembles per-host outputs.

Validated by tests/test_multihost.py: two real OS processes initialize a
CPU cluster via ``jax.distributed``, run the halo-sharded step over a
global 2-host mesh, and their predictions match the single-process run.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or skip joining) the multi-process JAX cluster.

    Resolution order: explicit args → FLOWGNN_COORDINATOR /
    FLOWGNN_NUM_PROCESSES / FLOWGNN_PROCESS_ID env vars → cluster
    auto-detection by ``jax.distributed`` (SLURM, …).
    Returns True when a multi-process runtime was initialized; False for
    the single-process case (everything else then behaves exactly as
    before — the same code path serves one host or many).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "FLOWGNN_COORDINATOR"
    )
    if num_processes is None and "FLOWGNN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FLOWGNN_NUM_PROCESSES"])
    if process_id is None and "FLOWGNN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FLOWGNN_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(edge: int = 1, devices=None):
    """Data×edge mesh over the whole cluster.

    The edge axis is filled from each host's LOCAL devices first (JAX
    device order groups by process), so edge-axis collectives — the
    per-layer halo all_to_all — stay on the device interconnect; only the
    embarrassingly parallel data axis spans DCN. ``edge`` must divide the local device
    count for that guarantee; a ValueError names the violation.
    """
    import jax
    from jax.sharding import Mesh

    devices = list(devices) if devices is not None else jax.devices()
    n_local = len([d for d in devices if d.process_index == devices[0].process_index])
    if edge > 1 and n_local % edge != 0:
        raise ValueError(
            f"edge={edge} does not divide the {n_local} local devices — "
            "edge-axis collectives would cross DCN"
        )
    data = len(devices) // edge
    arr = np.asarray(devices[: data * edge]).reshape(data, edge)
    return Mesh(arr, ("data", "edge"))


def shard_stream(
    buckets: Sequence, local_data: int = 1
) -> tuple[list, list[int]]:
    """This process's share of the bucket stream, grouped for its local mesh.

    Buckets are dealt round-robin across processes (every process must call
    this with the same stream — the usual multi-host SPMD contract:
    identical host programs, disjoint data), then grouped into
    ``local_data``-sized stacks for the host's local ('data', 'edge') mesh.
    DCN carries no per-layer traffic in this scheme — each bucket's
    collectives ride the local device interconnect.

    Returns ``(groups, real_counts)``: a trailing partial group is PADDED
    by repeating its last bucket (static mesh shapes need full stacks);
    ``real_counts[i]`` says how many of group i's rows are real so the
    caller drops the duplicate predictions — every submitted bucket is
    accounted for exactly once.
    """
    import jax

    mine = list(buckets[jax.process_index() :: jax.process_count()])
    groups, real = [], []
    for i in range(0, len(mine), local_data):
        g = list(mine[i : i + local_data])
        real.append(len(g))
        while len(g) < local_data:
            g.append(g[-1])
        groups.append(g)
    return groups, real


def gather_results(local_out: np.ndarray):
    """All-gather per-host result rows to every host (tiny [rows, G+1, 1]
    prediction arrays — one DCN all-gather per stream, not per layer)."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(local_out)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(local_out))
