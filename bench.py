"""Benchmark driver — the run_experiments.sh analog (one JSON line per model).

Headline metric (matches the reference's definition, run_experiments.sh:44-46):
average end-to-end device time per graph, whole dataset streamed per
measurement. Baseline: FlowGNN GIN on molhiv = 49.5 µs/graph on an Alveo U50
(BASELINE.md). ``vs_baseline`` = baseline_us / our_us (>1 ⇒ faster than the
FPGA).

The molhiv dataset zips are missing LFS blobs, so the stream is the
synthetic molhiv-shaped dataset (core/synthetic.py): same graph count (4113),
same node/edge distribution. Weights are seeded random draws at each model's
published widths (params/seeded.py); ``--reference DIR`` loads the
reference's weight binaries instead.

Default numerics: bf16 compute with f32 accumulation — the analog of the
reference's 16-bit fixed point (GIN/src/dcl.h:58-59). --f32 for full float32.

The benchmark runs on a GPU and fails without one; ``--cpu-rehearsal``
allows a CPU run, and its results name the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

# U50 per-graph latency baselines (BASELINE.md): molhiv counts are from the
# reference repo (4113, GIN/src/dcl.h:39); molpcba uses the official OGB
# graph count (43793) and hep10k its eponymous 10000 to derive per-graph
# time from the committed total kernel ms.
U50_BASELINES_US = {
    "molhiv": {"gin": 49.5, "gin-vn": 56.2, "gcn": 41.9, "gat": 17.6,
               "pna": 57.4, "dgn": 32.9},
    "molpcba": {"gin": 51.4, "gin-vn": 58.6, "gcn": 44.0, "gat": 18.2,
                "pna": 59.9, "dgn": 34.5},
    "hep10k": {"gin": 179.9, "gin-vn": 207.6, "gcn": 163.9, "gat": 54.4,
               "pna": 157.8, "dgn": 138.2},
}
# Default stream lengths: molhiv is its official count (4113); molpcba and
# hep10k default to a SAMPLE of the same synthetic distribution, not the
# official 43793/10000 (per-graph normalization makes the metric
# stream-length independent). Pass --graphs for a full-count run.
DEFAULT_STREAM_GRAPHS = {"molhiv": 4113, "molpcba": 6144, "hep10k": 2048}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    # Default "all": the no-arg run records the whole table (one JSON line
    # per model + an aggregate line), matching the reference's all-models
    # discipline (run_experiments.sh:52-60).
    ap.add_argument("--model", default="all", help="gin|gin-vn|gcn|gat|pna|dgn|all")
    ap.add_argument("--dataset", default="molhiv", help="molhiv|molpcba|hep10k (synthetic profile)")
    ap.add_argument("--graphs", type=int, default=None, help="override graph count")
    ap.add_argument("--trials", type=int, default=5, help="report best-of")
    ap.add_argument("--reps", type=int, default=20,
                    help="stream passes per trial, enqueued back to back")
    ap.add_argument("--f32", action="store_true")
    # Bucket cap of 32k nodes: not yet measured on the GPU (ROADMAP.md).
    ap.add_argument("--node-cap", type=int, default=32768)
    ap.add_argument("--edge-cap", type=int, default=None,
                    help="bucket edge capacity (default: auto from the "
                         "stream's edge/node density so buckets fill the "
                         "node axis — a too-small cap silently halves "
                         "bucket occupancy and doubles per-graph time)")
    ap.add_argument("--graph-cap", type=int, default=2048)
    ap.add_argument("--reference", default=None, metavar="DIR",
                    help="load the reference weight binaries from DIR "
                         "instead of seeded weights")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a run on the CPU (results name the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; prints the JSON lines and returns the per-model
    results keyed by model name."""
    args = parse_args(argv)

    from flowgnn_tpu.runtime.compile_cache import configure_compile_cache

    configure_compile_cache()

    from flowgnn_tpu.bench.device import card_info, require_gpu
    from flowgnn_tpu.bench.protocol import time_stream
    from flowgnn_tpu.bench.roofline import peaks, report as roofline_report
    from flowgnn_tpu.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu.core.numerics import BF16, FLOAT32
    from flowgnn_tpu.core.synthetic import synthetic_dataset
    from flowgnn_tpu.models import registry
    from flowgnn_tpu.models.base import as_batch, prepare_params

    device = require_gpu(args.cpu_rehearsal)
    card = card_info()
    chip = peaks(device["kind"]) if device["platform"] == "gpu" else None
    prec = FLOAT32 if args.f32 else BF16
    baselines_us = U50_BASELINES_US[args.dataset]
    num_graphs = (
        args.graphs if args.graphs is not None
        else DEFAULT_STREAM_GRAPHS[args.dataset]
    )

    names = list(baselines_us) if args.model == "all" else [args.model]
    results = {}
    for name in names:
        spec = registry.get(name)
        params = registry.load_params(name, reference=args.reference)
        jparams = prepare_params(params, prec)
        graphs = registry.apply_transforms(
            spec,
            synthetic_dataset(args.dataset, seed=0, with_eigen=spec.needs_eigen,
                              num_graphs=num_graphs),
        )
        edge_cap = args.edge_cap or auto_edge_capacity(graphs, args.node_cap)
        buckets = list(
            pack_dataset(
                graphs,
                node_capacity=args.node_cap,
                edge_capacity=edge_cap,
                graph_capacity=args.graph_cap,
                with_eigen=spec.needs_eigen,
            )
        )
        batches = [as_batch(b) for b in buckets]
        total_graphs = sum(b.num_graphs for b in buckets)
        total_edges = sum(int(b.n_edge[:-1].sum()) for b in buckets)
        total_nodes = sum(int(b.n_node[:-1].sum()) for b in buckets)

        best, avg = time_stream(
            spec, jparams, batches, prec, args.reps, args.trials
        )
        us_per_graph = best / total_graphs * 1e6
        r = {
            "us_per_graph": us_per_graph,
            "us_per_graph_avg": avg / total_graphs * 1e6,
            "graphs_per_s": total_graphs / best,
            "edges_per_s": total_edges / best,
            "vs_baseline": baselines_us[name] / us_per_graph,
            "buckets": len(buckets),
        }
        detail = (
            f"# {name}: {us_per_graph:.3f} us/graph best "
            f"(avg {r['us_per_graph_avg']:.3f}, {r['graphs_per_s']:.0f} "
            f"graphs/s, {r['edges_per_s'] / 1e6:.2f}M edges/s, "
            f"{r['vs_baseline']:.2f}x U50, {len(buckets)} buckets"
        )
        if chip is not None:
            roof = roofline_report(
                name, total_nodes, total_edges, best, chip, bf16=not args.f32
            )
            r["roofline_frac"] = roof["roofline_frac"]
            detail += (
                f", analytic model {roof['roofline_frac'] * 100:.1f}% of "
                f"{chip.name} light speed"
            )
        print(detail + f") on {device['kind']} / {card['name']} "
              f"{card['power_limit']}", file=sys.stderr)
        results[name] = r

    common = {"device": device, "card": card}
    for name in names:
        r = results[name]
        print(json.dumps({
            "metric": f"{name}_{args.dataset}_synth_us_per_graph",
            "value": round(r["us_per_graph"], 3),
            "unit": "us/graph",
            "vs_baseline": round(r["vs_baseline"], 3),
            **common,
        }))
    if len(names) > 1:
        # Aggregate LAST line: the geometric-mean speedup over the U50 across
        # all models, with the per-model table embedded so one captured line
        # holds the record.
        gm = math.exp(
            sum(math.log(results[m]["vs_baseline"]) for m in names)
            / len(names)
        )
        print(json.dumps({
            "metric": f"all_{args.dataset}_synth_geomean_speedup",
            "value": round(gm, 3),
            "unit": "x_vs_u50",
            "vs_baseline": round(gm, 3),
            "models": {
                m: {
                    "us_per_graph": round(results[m]["us_per_graph"], 3),
                    "vs_baseline": round(results[m]["vs_baseline"], 3),
                }
                for m in names
            },
            **common,
        }))
    return results


if __name__ == "__main__":
    main()
