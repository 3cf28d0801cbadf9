"""Smoke test of the main path on one GPU: every model, the benchmark and the
serving stream, checked against the f64 NumPy oracles.

    python3 chip_smoke.py            # one GPU, every phase below
    python3 chip_smoke.py --multi    # four GPUs, the sharded paths only
    python3 chip_smoke.py --cpu-rehearsal [--multi]   # tiny sizes on the CPU

Phases (one process; nothing else touches the card):

  device  platform, kind and count; the card's name and power limit from
          nvidia-smi; the JAX version.
  models  each of the six models with seeded weights at its published
          widths, on one full bucket of the molhiv-shaped synthetic stream:
          the compiled forward's memory analysis, then BF16, FLOAT32 (dots
          at HIGHEST) and FLOAT32 with default dots (TF32 on the card, on
          record only), each compared on the bucket's first graphs with
          the f64 oracle (reference/oracles.py).
  bench   bench.py's main, in-process, for all six models.
  serve   runtime/stream.InferenceStream across two weight sets, compared
          with the jitted forward on the same graphs.
  memory  the device's peak bytes in use.
  multi   (--multi only, and nothing else) parallel/inference.halo_forward
          on 2x2 and 1x4 data x edge meshes for all six models, plus
          sharded_forward for GIN, each compared with the one-card forward.

Any failed check fails the run: it exits nonzero and prints no result. On
success the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

from flowgnn_tpu.bench.device import NVIDIA_SMI_QUERY, nvidia_smi_line, require_gpu
from flowgnn_tpu.core.graphs import add_virtual_node, auto_edge_capacity, pack_dataset
from flowgnn_tpu.core.numerics import BF16, FLOAT32, Precision
from flowgnn_tpu.core.synthetic import synthetic_molhiv
from flowgnn_tpu.models import registry
from flowgnn_tpu.models.base import as_batch, prepare_params
from flowgnn_tpu.reference import oracles
from flowgnn_tpu.runtime.compile_cache import configure_compile_cache

MODELS = ("gin", "gin-vn", "gcn", "gat", "pna", "dgn")

# Error of a prediction vector a against the f64 oracle b, as the smallest
# t with |a - b| <= t + t·|b| everywhere (np.allclose with rtol = atol = t).
F32_TOL = 1e-4
# BF16 limits: 4x the error the same comparison gives on the CPU (64 graphs
# of synthetic_molhiv(seed=0), seeded weights, XLA:CPU) — gin 8.9e-3,
# gin-vn 6.6e-2, gcn 9.1e-3, gat 4.8e-3, pna 1.9e-2, dgn 2.5e-3. bf16 keeps
# 8 mantissa bits, and its rounding compounds through 4-5 layers; GIN-VN's
# virtual node sums every atom of a molecule, so its outputs (up to ~19)
# carry the largest absolute error.
BF16_TOL = {
    "gin": 0.036, "gin-vn": 0.27, "gcn": 0.037, "gat": 0.02, "pna": 0.076,
    "dgn": 0.01,
}
F32_DEFAULT_DOTS = Precision(default_dots=True)

FULL = dict(
    stream_graphs=1600, node_cap=32768, graph_cap=2048, compare=64,
    bench_graphs=1024, bench_trials=2, serve_graphs=384, serve_flip=64,
    serve_caps=(4096, 256), multi_graphs=4113, multi_node_cap=32767,
    multi_graph_cap=2048,
)
TINY = dict(
    stream_graphs=24, node_cap=512, graph_cap=32, compare=8,
    bench_graphs=16, bench_trials=1, serve_graphs=24, serve_flip=5,
    serve_caps=(256, 16), multi_graphs=24, multi_node_cap=255,
    multi_graph_cap=8,
)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def oracle_error(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def model_graphs(name: str, num_graphs: int):
    """(raw graphs, graphs with the model's transforms applied)."""
    spec = registry.get(name)
    raw = synthetic_molhiv(num_graphs, seed=0, with_eigen=spec.needs_eigen)
    return raw, registry.apply_transforms(spec, raw)


def first_bucket(spec, graphs, node_cap: int, graph_cap: int):
    return next(iter(pack_dataset(
        graphs, node_capacity=node_cap,
        edge_capacity=auto_edge_capacity(graphs, node_cap),
        graph_capacity=graph_cap, with_eigen=spec.needs_eigen,
    )))


def oracle_outputs(name: str, params: dict, raw, transformed) -> np.ndarray:
    """f64 NumPy oracle per graph. GAT's oracle adds its own self loops;
    GIN-VN's gets the materialised virtual-node star, not the analytic one
    the model runs."""
    if name == "gat":
        graphs = raw
    elif name == "gin-vn":
        graphs = [add_virtual_node(g) for g in raw]
    else:
        graphs = transformed
    oracle = oracles.ORACLES["gin" if name == "gin-vn" else name]
    return np.array([oracle(params, g)["out"].ravel()[0] for g in graphs])


def phase_device(cpu_rehearsal: bool = False) -> dict:
    import jax

    info = require_gpu(cpu_rehearsal)
    log("device", f"platform={info['platform']} kind={info['kind']} "
                  f"count={info['count']} jax={jax.__version__}")
    log("device", f"{' '.join(NVIDIA_SMI_QUERY)}: {nvidia_smi_line()}")
    return info


def phase_models(models=MODELS, stream_graphs=1600, node_cap=32768,
                 graph_cap=2048, compare=64) -> dict:
    """Per model: memory analysis, then each precision's oracle error on
    the first ``compare`` graphs of one full bucket. Raises if BF16 or
    FLOAT32 leaves its limit."""
    import jax

    errors, failed = {}, []
    for name in models:
        spec = registry.get(name)
        params = registry.load_params(name)
        raw, graphs = model_graphs(name, stream_graphs)
        bucket = first_bucket(spec, graphs, node_cap, graph_cap)
        n = min(compare, bucket.num_graphs)
        batch = jax.device_put(as_batch(bucket))
        t0 = time.perf_counter()
        want = oracle_outputs(name, params, raw[:n], graphs[:n])
        oracle_s = time.perf_counter() - t0
        errors[name] = {}
        for label, prec in (("bf16", BF16), ("f32_highest", FLOAT32),
                            ("f32_default_dots", F32_DEFAULT_DOTS)):
            jp = jax.device_put(prepare_params(params, prec))
            t0 = time.perf_counter()
            compiled = jax.jit(
                lambda p, b, prec=prec: spec.forward(p, b, prec)
            ).lower(jp, batch).compile()
            compile_s = time.perf_counter() - t0
            if label != "f32_default_dots":
                m = compiled.memory_analysis()
                log("models", f"{name} {label} memory_analysis: "
                    f"args={m.argument_size_in_bytes} "
                    f"out={m.output_size_in_bytes} "
                    f"temp={m.temp_size_in_bytes} "
                    f"code={m.generated_code_size_in_bytes} "
                    f"(compile {compile_s:.1f} s)")
            out = np.asarray(compiled(jp, batch).astype(np.float32))
            if not np.all(np.isfinite(out[: bucket.num_graphs])):
                failed.append(f"{name} {label}: non-finite output")
            err = oracle_error(out[:n, 0], want)
            errors[name][label] = err
            limit = {"bf16": BF16_TOL[name], "f32_highest": F32_TOL}.get(label)
            verdict = "on record" if limit is None else (
                "ok" if err <= limit else "FAIL")
            log("models", f"{name} {label}: error {err:.3e} vs f64 oracle "
                f"on {n} graphs (limit {limit}) {verdict}")
            if verdict == "FAIL":
                failed.append(f"{name} {label}: {err:.3e} > {limit}")
        log("models", f"{name}: bucket {bucket.num_graphs} graphs, "
            f"{int(bucket.n_node[:-1].sum())} nodes, "
            f"{int(bucket.n_edge[:-1].sum())} edges; oracle {oracle_s:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return errors


def phase_bench(graphs=1024, trials=2, model="all", cpu_rehearsal=False) -> dict:
    import bench

    argv = ["--model", model, "--graphs", str(graphs), "--trials", str(trials)]
    if cpu_rehearsal:
        argv += ["--cpu-rehearsal", "--reps", "1", "--node-cap", "512",
                 "--graph-cap", "32"]
    results = bench.main(argv)
    card = nvidia_smi_line()
    for name, r in results.items():
        log("bench", f"{name}: {r['us_per_graph']} us/graph "
            f"({r['graphs_per_s']:.0f} graphs/s, {r['buckets']} buckets) "
            f"on {card}")
    return results


def phase_serve(model="gin", num_graphs=384, flip=64, caps=(4096, 256)) -> int:
    """The stream answers ``num_graphs`` graphs whose weight set flips every
    ``flip`` graphs; each prediction must match the jitted forward of the
    same graphs under the same weights."""
    import jax

    from flowgnn_tpu.core.graphs import pack_graphs
    from flowgnn_tpu.runtime.stream import InferenceStream

    spec = registry.get(model)
    sets = [registry.load_params(model, seed) for seed in (0, 1)]
    raw, graphs = model_graphs(model, num_graphs)
    node_cap, graph_cap = caps
    edge_cap = auto_edge_capacity(graphs, node_cap)
    stream = InferenceStream(model, sets, FLOAT32, node_capacity=node_cap,
                             edge_capacity=edge_cap, graph_capacity=graph_cap)
    items = [(g, (i // flip) % 2) for i, g in enumerate(raw)]
    t0 = time.perf_counter()
    got = np.array(list(stream.run(items)))
    serve_s = time.perf_counter() - t0

    fwd = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))
    want = []
    for start in range(0, num_graphs, flip):
        chunk = graphs[start : start + flip]
        params = prepare_params(sets[(start // flip) % 2], FLOAT32)
        for bucket in pack_dataset(chunk, node_cap, edge_cap, graph_cap,
                                   with_eigen=spec.needs_eigen):
            out = np.asarray(fwd(params, as_batch(bucket)))
            want.extend(out[: bucket.num_graphs, 0])
    err = oracle_error(got, np.asarray(want))
    flips = sum(1 for a, b in zip(items, items[1:]) if a[1] != b[1])
    log("serve", f"{model}: {len(got)} graphs, {flips} weight flips, "
        f"{serve_s:.2f} s incl. compile; max error vs forward {err:.3e} "
        f"(limit {F32_TOL})")
    if got.shape != (num_graphs,) or not err <= F32_TOL:
        raise AssertionError(f"serve: stream != forward ({err:.3e})")
    if np.allclose(got[:flip], got[flip : 2 * flip]):
        raise AssertionError("serve: the two weight sets agree")
    return len(got)


def phase_memory() -> None:
    import jax

    stats = jax.devices()[0].memory_stats()
    peak = None if stats is None else stats.get("peak_bytes_in_use")
    log("memory", f"peak_bytes_in_use={peak}")


def phase_multi(models=MODELS, num_graphs=4113, node_cap=32767,
                graph_cap=2048) -> dict:
    """Sharded forwards on four devices vs the one-device forward."""
    import jax

    from flowgnn_tpu.parallel.halo import build_halo_batch
    from flowgnn_tpu.parallel.inference import (
        halo_forward, sharded_forward, stack_buckets, stack_halo_buckets,
    )
    from flowgnn_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--multi needs 4 devices, JAX sees {len(devices)}")
    errors, failed = {}, []
    for name in models:
        spec = registry.get(name)
        jp = prepare_params(registry.load_params(name), FLOAT32)
        _, graphs = model_graphs(name, num_graphs)
        buckets = list(pack_dataset(
            graphs, node_capacity=node_cap,
            edge_capacity=auto_edge_capacity(graphs, node_cap),
            graph_capacity=graph_cap, with_eigen=spec.needs_eigen,
        ))[:2]
        single = jax.jit(lambda p, b: spec.forward(p, b, FLOAT32))
        want = [np.asarray(single(jp, as_batch(b))) for b in buckets]
        runs = [
            (f"halo {d}x{e}", halo_forward(spec.forward, make_mesh(d, e, devices), FLOAT32),
             stack_halo_buckets([build_halo_batch(b, k=e, edge_slack=2.0)
                                 for b in buckets[:d]]))
            for d, e in ((2, 2), (1, 4))
        ]
        if name == "gin":
            runs.append(("psum 2x2", sharded_forward(
                spec.forward, make_mesh(2, 2, devices), FLOAT32),
                stack_buckets(buckets[:2])))
        for label, fwd, stacked in runs:
            t0 = time.perf_counter()
            out = np.asarray(fwd(jp, stacked))
            run_s = time.perf_counter() - t0
            err = max(
                oracle_error(out[i][: b.num_graphs], want[i][: b.num_graphs])
                for i, b in enumerate(buckets[: out.shape[0]])
            )
            errors[(name, label)] = err
            verdict = "ok" if err <= F32_TOL else "FAIL"
            log("multi", f"{name} {label}: max error vs one device {err:.3e} "
                f"over {out.shape[0]} bucket(s) of "
                f"{buckets[0].num_graphs} graphs ({run_s:.1f} s incl. "
                f"compile) {verdict}")
            if verdict == "FAIL":
                failed.append(f"{name} {label}: {err:.3e}")
    if failed:
        raise AssertionError("; ".join(failed))
    return errors


def run_phase(name: str, fn, failures: list) -> None:
    t0 = time.perf_counter()
    try:
        fn()
    except Exception:  # noqa: BLE001 — report every phase, then fail
        failures.append(name)
        traceback.print_exc()
        log(name, "FAILED")
    log(name, f"done in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device sharded phase")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow the CPU and shrink every phase to a tiny size")
    args = ap.parse_args(argv)
    configure_compile_cache()
    size = TINY if args.cpu_rehearsal else FULL
    info = phase_device(args.cpu_rehearsal)

    failures: list = []
    if args.multi:
        run_phase("multi", lambda: phase_multi(
            num_graphs=size["multi_graphs"], node_cap=size["multi_node_cap"],
            graph_cap=size["multi_graph_cap"]), failures)
    else:
        run_phase("models", lambda: phase_models(
            stream_graphs=size["stream_graphs"], node_cap=size["node_cap"],
            graph_cap=size["graph_cap"], compare=size["compare"]), failures)
        run_phase("bench", lambda: phase_bench(
            size["bench_graphs"], size["bench_trials"],
            cpu_rehearsal=args.cpu_rehearsal), failures)
        run_phase("serve", lambda: phase_serve(
            num_graphs=size["serve_graphs"], flip=size["serve_flip"],
            caps=size["serve_caps"]), failures)
        run_phase("memory", phase_memory, failures)
    if failures:
        print(f"chip_smoke: failed phases: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    print(f"{' '.join(NVIDIA_SMI_QUERY)}: {nvidia_smi_line()}")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
