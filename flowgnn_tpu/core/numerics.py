"""Fixed-point emulation of the reference's ``ap_fixed`` numerics.

The reference computes in ``ap_fixed<16,6>`` (GIN/GCN/GAT/PNA —
GIN/src/dcl.h:58-59) or ``ap_fixed<16,3>`` (DGN — DGN/src/dcl.h:54-55):
16-bit signed fixed point with 6 (resp. 3) integer bits, i.e. a value grid of
2^-10 (resp. 2^-13) and range ±32 (resp. ±4). HLS defaults are AP_TRN
(truncate toward −∞) quantization and AP_WRAP (two's-complement wraparound)
overflow.

Exact bit-for-bit replay of the FPGA would additionally require replaying the
PE-interleaved accumulation order (dest mod 4 partitions, GIN/src/load_inputs.cc:127);
a parallel segment-sum necessarily reorders low-bit rounding. The framework
therefore offers a tolerance ladder:

  * ``float`` mode (default): pure f32, validated against the independent
    NumPy oracle to ~1e-6.
  * ``fixed`` mode: weights/inputs snapped to the ap_fixed grid on load and
    activations re-quantized at every logical stage boundary — reproduces the
    reference's quantization error envelope without replaying its
    accumulation order. Overflow may be 'sat' (default; saturate like
    AP_SAT) or 'wrap' (AP_WRAP fidelity).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class FixedSpec:
    """ap_fixed<width, int_bits> grid."""

    width: int = 16
    int_bits: int = 6
    overflow: Literal["sat", "wrap"] = "sat"

    @property
    def frac_bits(self) -> int:
        return self.width - self.int_bits

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def max_val(self) -> float:
        """Largest representable value ((2^(W-1)-1) / 2^f)."""
        return ((1 << (self.width - 1)) - 1) / self.scale

    @property
    def min_val(self) -> float:
        return -(1 << (self.width - 1)) / self.scale

    @property
    def epsilon(self) -> float:
        """ap_fixed_epsilon<T>() = one ulp (GIN/src/util.h:27-32)."""
        return 1.0 / self.scale

    def quantize_np(self, x: np.ndarray) -> np.ndarray:
        q = np.floor(np.asarray(x, np.float64) * self.scale)
        lo, hi = -(1 << (self.width - 1)), (1 << (self.width - 1)) - 1
        if self.overflow == "sat":
            q = np.clip(q, lo, hi)
        else:
            q = np.mod(q - lo, 1 << self.width) + lo
        return (q / self.scale).astype(np.float32)

    def quantize(self, x: jnp.ndarray) -> jnp.ndarray:
        q = jnp.floor(x.astype(jnp.float32) * self.scale)
        lo, hi = float(-(1 << (self.width - 1))), float((1 << (self.width - 1)) - 1)
        if self.overflow == "sat":
            q = jnp.clip(q, lo, hi)
        else:
            span = float(1 << self.width)
            q = jnp.mod(q - lo, span) + lo
        return q / self.scale


AP_FIXED_16_6 = FixedSpec(16, 6)
AP_FIXED_16_3 = FixedSpec(16, 3)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Numerics policy threaded through every model.

    ``compute_dtype`` is the dense-math dtype (f32, or bf16 for
    tensor-core throughput runs); ``fixed`` enables the ap_fixed emulation
    ladder. f32/f64 dots run at full precision unless ``default_dots``
    leaves them at the backend's default (TF32 on a GPU), which exists only
    to put TF32's error on record (chip_smoke.py).
    """

    compute_dtype: jnp.dtype = jnp.float32
    fixed: Optional[FixedSpec] = None
    default_dots: bool = False

    def q(self, x: jnp.ndarray) -> jnp.ndarray:
        """Quantize a stage-boundary activation (no-op in float mode)."""
        if self.fixed is None:
            return x
        return self.fixed.quantize(x)

    def q_np(self, x: np.ndarray) -> np.ndarray:
        if self.fixed is None:
            return np.asarray(x, np.float32)
        return self.fixed.quantize_np(x)


FLOAT32 = Precision()
FLOAT64 = Precision(compute_dtype=jnp.float64)  # needs jax_enable_x64 (tests)
BF16 = Precision(compute_dtype=jnp.bfloat16)
FIXED_16_6 = Precision(fixed=AP_FIXED_16_6)
FIXED_16_3 = Precision(fixed=AP_FIXED_16_3)
