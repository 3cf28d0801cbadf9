"""Experiment driver CLI — the run_experiments.sh analog.

Usage:
  python -m flowgnn_tpu.cli run [--model all|gin|...] [--dataset DIR|synth]
                                [--trials N] [--out DIR] [--f32]
                                [--reference DIR]

Weights are seeded random draws at each model's published widths unless
``--reference`` names the reference tree holding the trained binaries.

For each (model, dataset) case it mirrors the reference driver's protocol
(run_experiments.sh:28-49): load the dataset, run the whole stream through
the device ``trials`` times, report *average device time / graphs = ms per
graph*, and write:

  <out>/<model>_output.txt     — per-graph predictions "g%d: %.8f"
                                 (HLS_output.txt format, GIN/src/host.cc:213-222)
  <out>/summary.<model>.csv    — kernel-execution stats in the shape of the
                                 XRT profile summary the reference commits
                                 (GIN/summary.molhiv.csv:41)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _load_graphs(dataset: str, spec, num_graphs: int | None):
    from .core.synthetic import DATASET_PROFILES, synthetic_dataset, synthetic_molhiv
    from .core import io as gio

    if dataset == "synth":
        return synthetic_molhiv(
            num_graphs or 4113, seed=0, with_eigen=spec.needs_eigen
        )
    if dataset in DATASET_PROFILES:
        return synthetic_dataset(
            dataset, seed=0, with_eigen=spec.needs_eigen, num_graphs=num_graphs
        )
    return list(
        gio.read_dataset(dataset, num_graphs=num_graphs, with_eigen=spec.needs_eigen)
    )


def run_case(
    name: str,
    dataset: str,
    trials: int,
    out_dir: str,
    prec,
    reference: str | None = None,
    num_graphs: int | None = None,
    caps=(8192, 24576, 512),
    trace_dir: str | None = None,
) -> dict:
    import jax
    import numpy as np

    from .bench.device import device_info
    from .core.graphs import auto_edge_capacity, pack_dataset
    from .models import registry
    from .models.base import as_batch, prepare_params

    spec = registry.get(name)
    jparams = jax.device_put(
        prepare_params(registry.load_params(name, reference=reference), prec)
    )
    graphs = registry.apply_transforms(spec, _load_graphs(dataset, spec, num_graphs))
    buckets = list(
        pack_dataset(
            graphs,
            node_capacity=caps[0],
            edge_capacity=max(caps[1], auto_edge_capacity(graphs, caps[0])),
            graph_capacity=caps[2],
            with_eigen=spec.needs_eigen,
        )
    )
    batches = jax.device_put([as_batch(b) for b in buckets])
    counts = [b.num_graphs for b in buckets]
    total = sum(counts)

    fwd = jax.jit(lambda p, b: spec.forward(p, b, prec))
    jax.block_until_ready(fwd(jparams, batches[0]))  # compile + warm up

    from .bench.profiling import trace

    times = []
    pending = None
    with trace(trace_dir):
        for _ in range(trials):
            t0 = time.perf_counter()
            pending = [fwd(jparams, b) for b in batches]  # pipelined dispatch
            jax.block_until_ready(pending)
            times.append(time.perf_counter() - t0)
    outs = [np.asarray(o) for o in pending]

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_output.txt"), "w") as f:
        g = 1
        for out, k in zip(outs, counts):
            vals = out[:k, 0]
            for val in vals:
                f.write(f"g{g}: {float(val):.8f}\n")
                g += 1

    avg_ms = sum(times) / len(times) * 1e3
    mn, mx = min(times) * 1e3, max(times) * 1e3
    with open(os.path.join(out_dir, f"summary.{name}.csv"), "w") as f:
        f.write("Kernel Execution\n")
        f.write("Kernel,Number Of Enqueues,Total Time (ms),Average Time (ms),"
                "Minimum Time (ms),Maximum Time (ms)\n")
        f.write(
            f"{name}_compute_graphs,{trials},{sum(times) * 1e3:.6f},"
            f"{avg_ms:.6f},{mn:.6f},{mx:.6f}\n"
        )

    ms_per_graph = avg_ms / total
    return {
        "model": name,
        "dataset": dataset,
        "num_graphs": total,
        "avg_ms": avg_ms,
        "ms_per_graph": ms_per_graph,
        "graphs_per_s": total / (avg_ms / 1e3),
        "device": device_info(),
    }


def run_multihost(
    name: str,
    dataset: str,
    out_dir: str,
    prec,
    reference: str | None = None,
    num_graphs: int | None = None,
    edge_shards: int = 1,
    local_data: int = 1,
    caps=(8192, 24576, 512),
) -> dict:
    """Multi-host experiment driver — run_experiments.sh at pod scale.

    Every host runs this same entry (`cli run --multihost`, coordinates
    via FLOWGNN_COORDINATOR/NUM_PROCESSES/PROCESS_ID or cluster
    auto-detection): initialize → deal buckets round-robin
    (multihost.shard_stream, trailing partial groups padded and
    de-duplicated) → run each group on the host's LOCAL data×edge mesh
    (per-layer halo collectives ride the device interconnect, never DCN) → one DCN
    all-gather of the per-bucket predictions → host 0 writes the
    HLS_output.txt-shaped prediction file with EVERY graph accounted for
    in submission order."""
    import math

    import jax
    import numpy as np

    from .core.graphs import auto_edge_capacity, pack_dataset
    from .models import registry
    from .models.base import prepare_params
    from .parallel import multihost
    from .parallel.halo import build_halo_batch
    from .parallel.inference import halo_forward, stack_halo_buckets
    from .parallel.mesh import make_mesh

    multihost.initialize()  # env/cluster-driven; no-op single-process
    spec = registry.get(name)
    params = prepare_params(registry.load_params(name, reference=reference), prec)
    graphs = registry.apply_transforms(
        spec, _load_graphs(dataset, spec, num_graphs)
    )
    buckets = list(
        pack_dataset(
            graphs,
            node_capacity=caps[0],
            edge_capacity=max(caps[1], auto_edge_capacity(graphs, caps[0])),
            graph_capacity=caps[2],
            with_eigen=spec.needs_eigen,
        )
    )
    counts = [b.num_graphs for b in buckets]
    groups, real = multihost.shard_stream(buckets, local_data)
    mesh = make_mesh(
        data=local_data, edge=edge_shards, devices=jax.local_devices()
    )
    fwd = halo_forward(spec.forward, mesh, prec)
    rows: list[np.ndarray] = []
    for group, nreal in zip(groups, real):
        stacked = stack_halo_buckets(
            [
                build_halo_batch(b, k=edge_shards, edge_slack=4.0 * edge_shards)
                for b in group
            ]
        )
        out = np.asarray(fwd(params, stacked))  # [local_data, G+1, T]
        rows.extend(out[:nreal])
    # Equal-shape DCN all-gather: pad every host to the max row count.
    n_proc = jax.process_count()
    max_rows = math.ceil(len(buckets) / n_proc)
    gcap1 = buckets[0].n_node.shape[0]
    t_out = rows[0].shape[-1] if rows else 1
    local = np.zeros((max_rows, gcap1, t_out), np.float32)
    if rows:
        local[: len(rows)] = np.stack(rows)
    gathered = multihost.gather_results(local)
    if n_proc == 1:
        gathered = gathered[None]
    os.makedirs(out_dir, exist_ok=True)
    if jax.process_index() == 0:
        with open(os.path.join(out_dir, f"{name}_output.txt"), "w") as f:
            g = 1
            for i, k in enumerate(counts):  # global submission order
                row = gathered[i % n_proc, i // n_proc]
                for val in row[:k, 0]:
                    f.write(f"g{g}: {float(val):.8f}\n")
                    g += 1
    return {
        "model": name,
        "dataset": dataset,
        "num_graphs": sum(counts),
        "buckets": len(buckets),
        "hosts": int(n_proc),
        "mesh": {"data": local_data, "edge": edge_shards},
    }


def run_accuracy(
    name: str,
    dataset: str,
    prec,
    reference: str | None = None,
    num_graphs: int | None = None,
    metric: str = "auto",
) -> dict:
    """Score a labelled dataset: reference-layout dir with labels.csv (from
    ``convert``) or an OGB raw/ dir — SURVEY §4(c)'s OGB metric check."""
    import jax
    import numpy as np

    from .bench.metrics import average_precision, roc_auc
    from .core import ogb as ogb_io
    from .core.graphs import pack_dataset
    from .models import registry
    from .models.base import as_batch, prepare_params

    spec = registry.get(name)
    jparams = prepare_params(registry.load_params(name, reference=reference), prec)

    if os.path.exists(os.path.join(dataset, "num-node-list.csv")) or \
            os.path.exists(os.path.join(dataset, "num-node-list.csv.gz")):
        graphs, labels = ogb_io.load_ogb_raw(
            dataset, with_eigen=spec.needs_eigen, limit=num_graphs
        )
    else:
        labels = ogb_io.load_labels(dataset)
        if labels is None:
            raise SystemExit(
                f"{dataset} has no labels.csv — produce one with "
                "`python -m flowgnn_tpu.cli convert`"
            )
        graphs = _load_graphs(dataset, spec, num_graphs)
        labels = labels[: len(graphs)]
    graphs = registry.apply_transforms(spec, graphs)

    buckets = list(
        pack_dataset(
            graphs, node_capacity=8192, edge_capacity=24576,
            graph_capacity=512, with_eigen=spec.needs_eigen,
        )
    )
    fwd = jax.jit(lambda p, b: spec.forward(p, b, prec))
    scores = np.concatenate(
        [np.asarray(fwd(jparams, as_batch(b)))[: b.num_graphs, 0]
         for b in buckets]
    )
    if metric == "auto":
        metric = "ap" if labels.shape[1] > 1 else "rocauc"
    # The reference compiles NUM_TASK=1 (GIN/src/dcl.h) and these weights
    # predict a single output, so multi-task label files (molpcba) are
    # scored on task 0 only — averaging per-task metrics against one shared
    # prediction vector would look like an OGB AP without measuring one.
    if labels.shape[1] > 1:
        print(
            f"note: {labels.shape[1]}-task labels but the model head is "
            "single-task (reference NUM_TASK=1) — scoring task 0",
            file=sys.stderr,
        )
    value = (
        average_precision(labels[:, 0], scores)
        if metric == "ap"
        else roc_auc(labels[:, 0], scores)
    )
    return {"model": name, "dataset": dataset, "metric": metric,
            "value": float(value), "num_graphs": len(graphs)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="flowgnn_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def weights(p):
        p.add_argument("--reference", default=None, metavar="DIR",
                       help="load the reference weight binaries from DIR "
                            "instead of seeded weights")

    conv = sub.add_parser(
        "convert", help="OGB raw CSVs -> reference dataset layout + labels"
    )
    conv.add_argument("--raw", required=True, help="OGB dataset raw/ dir")
    conv.add_argument("--out", required=True)
    conv.add_argument("--eigen", action="store_true",
                      help="attach Laplacian eigenvectors (DGN)")
    conv.add_argument("--limit", type=int, default=None)

    acc = sub.add_parser("accuracy", help="score a labelled dataset")
    acc.add_argument("--model", required=True,
                     choices=["gin", "gin-vn", "gcn", "gat", "pna", "dgn"])
    acc.add_argument("--dataset", required=True,
                     help="reference-layout dir with labels.csv, or OGB raw/")
    acc.add_argument("--metric", default="auto",
                     choices=["auto", "rocauc", "ap"])
    acc.add_argument("--num-graphs", type=int, default=None)
    acc.add_argument("--f32", action="store_true")
    weights(acc)

    run = sub.add_parser("run", help="run inference experiments")
    run.add_argument(
        "--model", default="all",
        choices=["all", "gin", "gin-vn", "gcn", "gat", "pna", "dgn"],
    )
    run.add_argument("--dataset", default="synth",
                     help="'synth', a profile (molhiv|molpcba|hep10k), or a "
                          "reference-layout dataset dir")
    run.add_argument("--trace", default=None,
                     help="capture a jax.profiler trace into this logdir")
    run.add_argument("--num-graphs", type=int, default=None)
    run.add_argument("--trials", type=int, default=5)
    run.add_argument("--out", default="results")
    run.add_argument("--f32", action="store_true")
    weights(run)
    run.add_argument("--multihost", action="store_true",
                     help="multi-host driver: initialize jax.distributed "
                          "(FLOWGNN_COORDINATOR/NUM_PROCESSES/PROCESS_ID or "
                          "cluster auto-detection), deal buckets across "
                          "hosts, run each group on the local data×edge "
                          "mesh, all-gather predictions over DCN")
    run.add_argument("--edge-shards", type=int, default=1,
                     help="edge-axis width of each host's local mesh "
                          "(halo-exchange sharding)")
    run.add_argument("--local-data", type=int, default=1,
                     help="data-axis width of each host's local mesh "
                          "(buckets per step)")
    run.add_argument("--node-cap", type=int, default=8192)
    run.add_argument("--edge-cap", type=int, default=24576)
    run.add_argument("--graph-cap", type=int, default=512)
    args = ap.parse_args(argv)

    if args.cmd == "convert":
        from .core.ogb import convert_ogb

        n = convert_ogb(args.raw, args.out, with_eigen=args.eigen,
                        limit=args.limit)
        print(f"converted {n} graphs -> {args.out}", file=sys.stderr)
        return

    from .core.numerics import BF16, FLOAT32
    from .models import registry
    from .runtime.compile_cache import configure_compile_cache

    configure_compile_cache()
    prec = FLOAT32 if args.f32 else BF16

    if args.cmd == "accuracy":
        r = run_accuracy(args.model, args.dataset, prec, args.reference,
                         args.num_graphs, args.metric)
        print(f"{r['model']} {r['metric']} = {r['value']:.4f} "
              f"({r['num_graphs']} graphs)", file=sys.stderr)
        print(json.dumps(r))
        return
    if args.cmd == "run" and args.multihost:
        name = "gin" if args.model == "all" else args.model
        r = run_multihost(
            name, args.dataset, args.out, prec, args.reference,
            args.num_graphs, edge_shards=args.edge_shards,
            local_data=args.local_data,
            caps=(args.node_cap, args.edge_cap, args.graph_cap),
        )
        print(json.dumps(r))
        return

    names = list(registry.MODELS) if args.model == "all" else [args.model]
    results = []
    for name in names:
        r = run_case(
            name, args.dataset, args.trials, args.out, prec, args.reference,
            args.num_graphs,
            caps=(args.node_cap, args.edge_cap, args.graph_cap),
            trace_dir=args.trace,
        )
        results.append(r)
        print(
            f"{name} on {args.dataset}: {r['ms_per_graph'] * 1e3:.2f} us/graph "
            f"({r['graphs_per_s']:.0f} graphs/s)",
            file=sys.stderr,
        )
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
