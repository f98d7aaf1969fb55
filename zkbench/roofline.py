"""The yardstick of the roofline metrics: the card's peaks and the least
work of the field and group operations the prove asks for.

Peaks (NVIDIA H100 SXM): 32-bit integer multiply-adds at 64 a clock on
each SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
compute capability 9.0) times the SM count times the card's maximum SM
clock as ``nvidia-smi`` reports it; HBM3 at 3.35 TB/s (the data sheet).
The card's power limit is read beside them.

Work: a Montgomery product of N 32-bit words is 4N^2 + N multiply-adds
(264 for Fr, N = 8; 588 for Fq, N = 12); a point addition is 16 Fq
products, a mixed addition 11, a doubling 7.  Bytes count each input
element once and each output once at its packed size (32 bytes an Fr
element, 48 an Fq element, 96 an affine point), whatever layout the
program keeps.  An MSM of N points in S segments is counted at the least
work of a signed-digit bucket method over its best window c: for each of
ceil(255 / c) windows, N mixed additions and 2^c additions to reduce
2^(c-1) buckets, and 255 doublings to combine them; a scalar
multiplication at its doublings alone.  Each is a lower bound of what
any implementation without an endomorphism does, so a share computed
from it cannot pass 100% unless the time leaves out work.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

IMAD_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
SCALAR_BITS = 255
FR_IMADS, FQ_IMADS = 264, 588
FR_BYTES, FQ_BYTES, POINT_BYTES = 32, 48, 96
ADD, MIXED, DOUBLE = 16, 11, 7


@dataclasses.dataclass
class Peaks:
    sm_count: int
    clock_mhz: float
    power_limit_w: float

    @property
    def imad_per_s(self) -> float:
        return IMAD_PER_CLOCK_PER_SM * self.sm_count * self.clock_mhz * 1e6

    @property
    def bytes_per_s(self) -> float:
        return HBM_BYTES_PER_S

    @classmethod
    def read(cls):
        """The card's peaks, or None without a card or ``nvidia-smi``."""
        if not torch.cuda.is_available():
            return None
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True, timeout=30, check=True).stdout
            clock, power = (float(v) for v in out.strip().splitlines()[0].split(","))
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            return None
        return cls(torch.cuda.get_device_properties(0).multi_processor_count, clock, power)

    def least_s(self, imads: float, nbytes: float) -> float:
        return max(imads / self.imad_per_s, nbytes / self.bytes_per_s)


def msm_fq_products(points: int, bits: int = SCALAR_BITS) -> int:
    """The least Fq products of one MSM of ``points`` points."""
    best = None
    for c in range(1, 25):
        windows = -(-bits // c)
        cost = windows * (points * MIXED + (1 << c) * ADD) + bits * DOUBLE
        best = cost if best is None else min(best, cost)
    return best


def field_op(peaks: Peaks, field: str, op: str, n_a: int, n_b: int, n_out: int) -> float:
    """Least seconds of one elementwise op of ``field`` ("fr" or "fq")."""
    size = FR_BYTES if field == "fr" else FQ_BYTES
    imads = n_out * (FR_IMADS if field == "fr" else FQ_IMADS) if op == "mul" else 0
    return peaks.least_s(imads, (n_a + n_b + n_out) * size)


def point_op(peaks: Peaks, products: int, n_in: int, n_out: int, extra_bytes: int = 0) -> float:
    """Least seconds of ``n_out`` lanes of ``products`` Fq products each."""
    return peaks.least_s(n_out * products * FQ_IMADS, (n_in + n_out) * POINT_BYTES + extra_bytes)


def msm(peaks: Peaks, segments: int, points: int) -> float:
    """Least seconds of ``segments`` MSMs of ``points`` points each."""
    return peaks.least_s(segments * msm_fq_products(points) * FQ_IMADS,
                         segments * (points * (POINT_BYTES + FR_BYTES) + POINT_BYTES))
