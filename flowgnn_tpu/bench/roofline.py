"""Analytic cost models + roofline accounting per model family.

The reference publishes only end-to-end kernel times (XRT summary CSVs);
this adds a roofline view: for a packed stream we count matmul FLOPs and
memory bytes analytically, derive the light-speed time on the device, and
report ideal/measured.

Device peaks live in one table keyed by JAX's ``device_kind``. A device
that is not in the table is an error, not a default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float
    peak_f32_flops: float
    hbm_bytes_per_s: float
    source: str


# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit: 989 TFLOP/s bf16 (tensor cores), 67 TFLOP/s f32
# outside the tensor cores, 3.35 TB/s HBM3.
PEAKS: dict[str, ChipSpec] = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "H100 SXM", 989e12, 67e12, 3.35e12,
        "NVIDIA H100 Tensor Core GPU data sheet (SXM)",
    ),
}


def peaks(device_kind: str) -> ChipSpec:
    """Published peaks of ``device_kind``; KeyError for an unknown device."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no peaks for device kind {device_kind!r}; add its data-sheet "
            "row to bench/roofline.PEAKS"
        )
    return PEAKS[device_kind]


@dataclasses.dataclass
class Cost:
    flops: float
    bytes: float

    def light_speed_s(self, chip: ChipSpec, bf16: bool = True) -> float:
        peak = chip.peak_bf16_flops if bf16 else chip.peak_f32_flops
        return max(self.flops / peak, self.bytes / chip.hbm_bytes_per_s)

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)


def _mm(n: int, k: int, m: int, b: int) -> Cost:
    """n×k @ k×m matmul cost at b bytes/elem (weights assumed resident)."""
    return Cost(2.0 * n * k * m, b * (n * k + n * m))


def model_cost(name: str, num_nodes: int, num_edges: int, bytes_per_el: int = 2) -> Cost:
    """Per-stream forward cost. Dims/layers per SURVEY.md §2.5."""
    n, e, b = num_nodes, num_edges, bytes_per_el
    if name in ("gin", "gin-vn"):
        c = Cost(0, 0)
        for _ in range(5):
            c += _mm(n, 100, 200, b) + _mm(n, 200, 100, b)
            c += Cost(3 * e * 100, b * (3 * e * 100 + n * 100))  # msg+scatter
        return c
    if name == "gcn":
        c = Cost(0, 0)
        for _ in range(5):
            c += _mm(n, 100, 100, b)
            c += Cost(4 * e * 100, b * (3 * e * 100 + n * 100))
        return c
    if name == "gat":
        c = Cost(0, 0)
        for _ in range(5):
            c += _mm(n, 64, 64, b)  # linear projection (4 heads × 16 flat)
            c += _mm(n, 64, 64, b)  # skip projection
            c += Cost(5 * e * 64, b * (3 * e * 64 + n * 64))
        return c
    if name == "pna":
        c = Cost(0, 0)
        for _ in range(4):
            c += _mm(n, 12 * 80, 80, b)
            c += Cost(6 * e * 80, b * (4 * e * 80 + 4 * n * 80))
        return c
    if name == "dgn":
        c = Cost(0, 0)
        for _ in range(4):
            c += _mm(n, 200, 100, b)
            c += Cost(5 * e * 100, b * (3 * e * 100 + 2 * n * 100))
        return c
    raise KeyError(name)


def report(name: str, num_nodes: int, num_edges: int, measured_s: float,
           chip: ChipSpec, bf16: bool = True) -> dict:
    cost = model_cost(name, num_nodes, num_edges, 2 if bf16 else 4)
    ideal = cost.light_speed_s(chip, bf16)
    return {
        "gflops": cost.flops / 1e9,
        "gbytes": cost.bytes / 1e9,
        "light_speed_us": ideal * 1e6,
        "measured_us": measured_s * 1e6,
        "roofline_frac": ideal / measured_s if measured_s > 0 else 0.0,
        "achieved_tflops": cost.flops / measured_s / 1e12 if measured_s else 0.0,
    }
