"""Stream timing protocol (shared by bench.py and chip_smoke.py).

Mirrors the reference's measurement discipline (GIN/src/host.cc:203-210 +
run_experiments.sh:44-46): one pass runs the whole packed graph stream.
Parameters and batches are ``device_put`` once and passed to one jitted
pass as arguments. A warm-up call compiles the pass before timing; each
trial enqueues ``reps`` passes back to back and ends in
``block_until_ready`` on the last, so the host clock covers the device
work of every pass.
"""

from __future__ import annotations

import time

import numpy as np

# Scan-stack same-signature buckets beyond this count. Chosen on the
# earlier accelerator; not yet measured on the GPU (ROADMAP.md).
STACK_THRESHOLD = 6


def stream_pass(spec, prec, batches):
    """(jitted pass, device-resident stream) for ``batches``.

    ``pass_fn(params, stream)`` runs the whole stream once and returns one
    output per program. Buckets sharing one program signature (every
    bucket of ``core.graphs.pack_dataset``) are STACKED and driven by a
    ``lax.map`` when the group exceeds STACK_THRESHOLD, so program size and
    compile time stay independent of stream length; small groups stay
    unrolled."""
    import jax

    from ..models.base import batch_signature

    groups: dict = {}
    for batch in batches:
        groups.setdefault(batch_signature(batch), []).append(batch)
    kinds, stream = [], []
    for bs in groups.values():
        if len(bs) > STACK_THRESHOLD:
            kinds.append("scan")
            stream.append({k: np.stack([b[k] for b in bs]) for k in bs[0]})
        else:
            kinds.extend("single" for _ in bs)
            stream.extend(bs)

    def pass_fn(params, stream):
        outs = []
        for kind, b in zip(kinds, stream):
            if kind == "single":
                outs.append(spec.forward(params, b, prec))
            else:
                outs.append(
                    jax.lax.map(lambda bb: spec.forward(params, bb, prec), b)
                )
        return outs

    return jax.jit(pass_fn), jax.device_put(stream)


def time_stream(spec, jparams, batches, prec, reps: int, trials: int):
    """Time ``reps`` passes over ``batches`` per trial; returns (best, avg)
    seconds per pass (whole stream, all buckets)."""
    import jax

    pass_fn, stream = stream_pass(spec, prec, batches)
    jparams = jax.device_put(jparams)
    jax.block_until_ready(pass_fn(jparams, stream))  # compile + warm up

    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = pass_fn(jparams, stream)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / reps)
    return min(times), sum(times) / len(times)
