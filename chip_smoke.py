#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit; build every kernel from
   ``scalable_collaborative_zksnark_tpu_torch/csrc`` (one ``nvcc`` each,
   in parallel);
2. hold each kernel (Fr mul/add/sub, the Fq instances, the limb-major
   and tiled Fr products on 2^20 elements, also against Fr mul after the
   layout transform; the sumcheck fold phase; the G1 point ops, ``add_masked`` and ``add_reset`` on 2^16
   points and an edge set, the scalar ladder on 1,024 full scalars and 0,
   1, r - 1, the accumulate on a forced x-collision) bit for bit against
   its plain PyTorch version on the card, and time both (CUDA events,
   median of 10 or more for the kernels); print each kernel's registers
   and spill bytes, and the latency of one dependent multiply-add (a
   one-thread chain) that the chain bounds of Horner, bucket-serial and
   the ladder are built on;
3. the sumcheck path: ``c_sumcheck_product`` in leader mode at the
   gate-identity shape of the n = 16, l = 8 prove, ``[1, 6, 2^13, 16]``
   tables; launch counts are read around this one call; digest pinned;
   every kernel call of that run is recorded and replayed through the
   plain version on the same operands (bit equality);
4. the MSM paths of the same prove (leader mode, one party), each with
   the launch counts set to 0 just before it and read just after, a
   JAX-made digest pin, and host time (synchronised, median of 3): the
   random SRS bases (``srs_random``'s), (a) the ``c_commit`` of three
   polynomials (``d_msm`` over 8,192 bases), (b) the ``d_commit`` of
   three (``msm`` over 1,024), (c) a ``c_open`` q-vector chain
   (``msm_ragged`` over levels 4,096 .. 1, batch 3).  Every G1- and
   field-kernel call of (a) and (c) is replayed through its plain
   version; Horner, bucket-serial and the accumulate are timed at the
   shapes these calls gave them.  (a)-(c) run once more with
   ``SCZK_MSM_DENSE=0`` (the non-dense cores) against the same pins;
5. the main path: ``dhyperplonk`` at n = 16, l = 8, leader mode, through
   the bench entry (setup, warm-up, three synchronised proves, the split
   by span), then one prove in each MSM configuration with the counts
   set to 0 just before it and read just after; each prove's canonical
   digest and comm against the JAX-made pins; the non-dense prove's first
   and last ``add_masked`` step of every bucket loop replayed through the
   plain version; one more dense prove under ``torch.profiler`` (device
   time by kernel, the device's busy share); the (6, 1) prove in both
   configurations, pinned; the int8-engine configuration (``SCZK_MXU=1``):
   the gate identity against its pin, ``mxu_sumcheck.product_phase``
   against the fold-phase kernel on ``[6, 2^13]`` tables, the (16, 8)
   prove (warm-up and three timed proves, the last counted on its own:
   launches and int8 products) and the (6, 1) prove, pinned;
   ``scripts/mxu_micro.py``'s rows at its sizes;
   the ``scripts/exp_fieldmul.py`` path at 2^20 with its counts set to 0
   just before it: four formulations equal, both strided kernels
   launched, the product pinned;
6. the reference's sumcheck envelope, l = 32, with the seeds of
   ``examples/sumcheck.py``: ``c_sumcheck_product`` at n = 26 (pinned),
   local ``sumcheck_product`` at n = 20 (pinned), ``c_sumcheck_product``
   at n = 30 (timed only);
7. sim mode, l = 4 (32 parties), n = 20, shares from ``pack_from_public``:
   the opened transcript must pass ``check_sumcheck_product`` and equal the
   local transcript, and the party-net counters must equal the pins;
8. print the kernel table (one JSON line) and last
   ``{"ok": true, "device": {...}}``.

The pins (sha256 of the little-endian uint32 limb bytes, of normalized
points for the MSM paths, the proves' canonical 64-bit digests, and the
comm counters) were made from the JAX package on the CPU with the same
seeds and the same digest code, by ``test_chip_smoke_pins`` in
``tests/test_torch_sumcheck.py``, ``test_chip_smoke_msm_pins`` in
``tests/test_torch_msm.py``, ``test_chip_smoke_prove_pins`` in
``tests/test_torch_hyperplonk.py`` and ``test_chip_smoke_fieldmul_pin`` in
``tests/test_torch_fieldmul.py`` (marked slow), which recompute and check
them.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from scalable_collaborative_zksnark_tpu_torch import bench as bench_module
from scalable_collaborative_zksnark_tpu_torch import cuda_build
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves import g1 as g1_module
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1, map_points
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr
from scalable_collaborative_zksnark_tpu_torch.fields import fr as fr_module
from scalable_collaborative_zksnark_tpu_torch.fields import mxu
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import dhyperplonk
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import msm as msm_module
from scalable_collaborative_zksnark_tpu_torch.primitives import mxu_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck as sumcheck_module
from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import rand_points_flat
from scalable_collaborative_zksnark_tpu_torch.primitives.sumcheck import (
    c_sumcheck_product,
    check_sumcheck_product,
    sumcheck_product,
)
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.scripts import exp_fieldmul, mxu_micro
from scalable_collaborative_zksnark_tpu_torch.utils import timer
from scalable_collaborative_zksnark_tpu_torch.utils.digest import (
    limb_digest,
    point_digest,
    proof_digest,
)

FIELD = "bls12_381_fr"
# Inputs of each pinned call: log2 size, packing factor, batch, seeds of
# (f, g, challenges); number of challenges is n + 4, as in the example.
GATE = {"n": 16, "l": 8, "batch": 6, "seeds": (11, 12, 13)}
ENVELOPE = {"n": 26, "l": 32, "seeds": (1, 2, 3)}
LOCAL = {"n": 20, "seeds": (4, 5, 3)}
TOP = {"n": 30, "l": 32, "seeds": (1, 2, 3)}
SIM = {"n": 20, "l": 4, "seeds": (21, 22, 23)}
# The MSM paths of the n = 16, l = 8 prove: SRS sizes and seeds of bases
# and scalars.  c_commit: the three wire polynomials' commit (2^16 / l
# packed bases); d_commit: three per-party 2^10 commits; c_open: the
# q-vector chain of three polynomials, levels 4,096 .. 1.
COMMIT = {"n": 8192, "l": 8, "batch": 3, "seeds": (31, 32)}
DCOMMIT = {"n": 1024, "batch": 3, "seeds": (33, 34)}
OPEN = {"top": 4096, "batch": 3, "seeds": (35, 36)}
PINS = {
    "gate": "f7e08c95ce2e783ffaea257927acf5fd5d507d14ece420d691c1af4a4c099f0b",
    "envelope": "d1663780c5fd5c893992c327495f23e9187ac6f71b168410ea55b16c428760cd",
    "local": "a28e790618ad3a6d3cd6e153212104c26ffbe5a36273b1b823a98b2f61f31242",
    # (up[0], down[0], up[1], down[1], rounds) after the sim call
    "sim_comm": (8432, 1984, 64, 272, 4),
    "commit_bases": "11f5b65453c60a9f7ec6f9b896465cffc73c7aae4abc880f3bbccb9eb84ed5b8",
    "c_commit": "7aa7e7aac7dcbfaf9049e170cf7f2744ad3b6be89a48dee0f9cb58aa1bdc11e2",
    # (up[0], down[0], up[1], down[1], rounds) after the c_commit call
    "c_commit_comm": (9576, 9576, 152, 152, 2),
    "d_commit": "de71933757f550bce55bb74f3d58fa698eef57a817005681dbb8e1f9502b62cb",
    "c_open": "3941801c515593f3fe6063451492191ae82708e0b591e30ad6b8703f71baa9ae",
    # the leader-mode prove: canonical digests (bench.py's CONFORMANCE_PIN)
    # and, at (16, 8), (up[0], down[0], up[1], down[1], rounds) of one prove
    "prove_n16_l8": 0x8D7A4D5DE7FF827B,
    "prove_n6_l1": 0x0D8B55994DD236A9,
    "prove_n16_l8_comm": (3303721, 3930193, 1078689, 1068745, 131),
    # Field.mul of F.random((2^20,), 1) and F.random((2^20,), 2) (exp_fieldmul)
    "exp_fieldmul": "418666c20302a906ec8cc4417ca1a4142bef5ee98880bc4009046fe174bba65e",
}
# The main path: dhyperplonk in leader mode at the JAX package's flagship
# size, and the small size its CPU tests pin.
PROVE = {"n": 16, "l": 8}
SMALL_PROVE = {"n": 6, "l": 1}

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
IMAD_PER_SM_CLOCK = 64  # 32-bit integer multiply(-add) per SM per clock, cc 9.0

KERNELS = {
    "fr_mul": ("scalable_collaborative_zksnark_tpu_torch/csrc/fr.cu",
               "scalable_collaborative_zksnark_tpu/fields/pallas_fr.py:262"),
    "fr_add": ("scalable_collaborative_zksnark_tpu_torch/csrc/fr.cu",
               "scalable_collaborative_zksnark_tpu/fields/pallas_fr.py:268"),
    "fr_sub": ("scalable_collaborative_zksnark_tpu_torch/csrc/fr.cu",
               "scalable_collaborative_zksnark_tpu/fields/pallas_fr.py:278"),
    "sumcheck_product_phase": (
        "scalable_collaborative_zksnark_tpu_torch/csrc/sumcheck.cu",
        "scalable_collaborative_zksnark_tpu/primitives/pallas_sumcheck.py:38"),
}
_G1_SRC = "scalable_collaborative_zksnark_tpu_torch/csrc/g1.cu"
_PALLAS_G1 = "scalable_collaborative_zksnark_tpu/curves/pallas_g1.py"
G1_KERNELS = {
    "g1_add": (_G1_SRC, f"{_PALLAS_G1}:129"),
    "g1_add_mixed": (_G1_SRC, f"{_PALLAS_G1}:129"),
    "g1_double": (_G1_SRC, f"{_PALLAS_G1}:200"),
    "g1_accumulate": (_G1_SRC, f"{_PALLAS_G1}:180"),
    "g1_scalar_mul": (_G1_SRC, f"{_PALLAS_G1}:207"),
    "g1_horner": (_G1_SRC, f"{_PALLAS_G1}:358"),
    "g1_bucket_serial": (_G1_SRC, f"{_PALLAS_G1}:497"),
    "g1_add_masked": (_G1_SRC, f"{_PALLAS_G1}:144"),
    "g1_add_reset": (_G1_SRC, f"{_PALLAS_G1}:161"),
}
_FR_SRC = "scalable_collaborative_zksnark_tpu_torch/csrc/fr.cu"
FIELDMUL_KERNELS = {
    "fr_mul_limb_major": (_FR_SRC, "scripts/exp_fieldmul.py:95"),
    "fr_mul_tiled": (_FR_SRC, "scripts/exp_fieldmul.py:154"),
}
G1_WRAPPERS = ("add", "add_mixed", "double", "accumulate", "scalar_mul", "horner", "bucket_serial",
               "add_masked", "add_reset")
# kernels that the MSM paths must launch (add_mixed and double are off the
# leader path: phase 2 alone holds them)
MSM_PATH_KERNELS = ("g1_add", "g1_accumulate", "g1_scalar_mul", "g1_horner", "g1_bucket_serial",
                    "fr_mul")
# kernels that one prove must launch, in each MSM configuration
PROVE_KERNELS = ("fr_mul", "fr_add", "fr_sub", "sumcheck_product_phase", "g1_add",
                 "g1_scalar_mul", "g1_horner")
PROVE_DENSE_KERNELS = PROVE_KERNELS + ("g1_accumulate",)
PROVE_NONDENSE_KERNELS = PROVE_KERNELS + ("g1_add_masked",)
# the int8-engine prove runs every product sumcheck without the phase kernel
PROVE_MXU_KERNELS = tuple(k for k in PROVE_DENSE_KERNELS if k != "sumcheck_product_phase")
OFF_PATH = {"g1_add_mixed": "off the leader path; held by phase 2 alone",
            "g1_double": "off the leader path; held by phase 2 alone",
            "g1_add_reset": "no caller in either package; held by phase 2 alone",
            "fr_mul_limb_major": "off the prove; on the exp_fieldmul script's path",
            "fr_mul_tiled": "off the prove; on the exp_fieldmul script's path"}
FQ_MULS = 4 * 12 * 12 + 12  # 32-bit multiplies of one Fq CIOS product
# products per op on the critical path of one thread (general or mixed
# add: Z1Z1 -> U2 -> HH -> J -> Y3; double: B -> t -> ... -> Y3)
ADD_DEPTH, DOUBLE_DEPTH = 5, 3


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``reps`` runs of ``fn``, each between CUDA
    events (after one warm-up run)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, reps: int) -> float:
    """Median wall milliseconds of ``reps`` synchronised runs (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _mont_muls(words: int) -> int:
    """32-bit multiplies of one CIOS product: a*b and m*p words (lo and hi
    each) plus one m = t0 * n0 per word."""
    return 4 * words * words + words


def _bound_ms(nbytes: float, muls: float, int_rate: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = muls / int_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _equal(name: str, out, ref) -> int:
    """The largest difference between ``out`` and ``ref`` over every tensor
    and int (nested tuples); raises naming the kernel if it is not 0."""
    if isinstance(out, torch.Tensor):
        err = _max_abs_err(out, ref)
    elif isinstance(out, (tuple, list)):
        err = max((_equal(name, a, b) for a, b in zip(out, ref, strict=True)), default=0)
    else:
        err = abs(out - ref)
    if err:
        raise AssertionError(f"{name}: kernel differs from plain version by {err}")
    return err


def _g1_bound(products: float, nbytes: float, chain: float, int_rate: float, lat_ms: float):
    """(bound_ms, bound_by, kind): the larger of bytes over HBM rate,
    products * 588 multiplies over the integer rate, and the longest
    per-thread chain of dependent products times the least time of one
    product along a chain (``chain_latency``)."""
    bound, by = _bound_ms(nbytes, products * FQ_MULS, int_rate)
    if chain * lat_ms > bound:
        return chain * lat_ms, "operations", "dependent-product chain"
    return bound, by, "throughput"


def _g1_row(name: str, shape, err: int, ms: float, plain_ms: float, bound) -> dict:
    return {"kernel": name, "shape": list(shape), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_kind": bound[2], "library_ms": None, **cuda_g1.attributes(name)}


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_elementwise(F, m: int, int_rate: float) -> list[dict]:
    a = F.random((m,), 101)
    b = F.random((m,), 102)
    edge = F.array_from_ints([0, 1, F.p - 1, F.spec.r % F.p, (F.p - 1) // 2])
    a = torch.cat([a, edge.repeat_interleave(5, dim=0)])
    b = torch.cat([b, edge.repeat(5, 1)])
    rows = []
    for op in ("mul", "add", "sub"):
        kern = getattr(cuda_fr, op)
        plain = getattr(cuda_fr, f"{op}_plain")
        out = kern(F.spec, a, b)
        ref = plain(F.spec, a, b)
        torch.cuda.synchronize()
        err = _max_abs_err(out, ref)
        if err:
            raise AssertionError(f"{F.spec.name} {op}: kernel differs from plain version by {err}")
        n = a.shape[0]
        muls = n * _mont_muls(F.spec.num_words) if op == "mul" else 0
        bound, by = _bound_ms(3 * n * F.L * 4, muls, int_rate)
        rows.append({
            "op": op, "field": F.spec.name, "shape": [n, F.L], "max_abs_err": err,
            "ms": _ms(lambda: kern(F.spec, a, b)),
            "plain_ms": _ms(lambda: plain(F.spec, a, b)),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    # broadcast operands as the path passes them: one constant (period 1),
    # a repeated trailing block (period 1024), and an outer product as in
    # pss2ss ([64, 1] x [1, 256]: the first is materialised, the second
    # read with period 256)
    blk = 1024
    cases = [(a, b[0]), (a[: m // blk * blk].reshape(-1, blk, F.L), b[:blk]),
             (a[:64, None], b[None, :256])]
    for x, y in cases:
        for op in ("mul", "add", "sub"):
            err = _max_abs_err(getattr(cuda_fr, op)(F.spec, x, y),
                               getattr(cuda_fr, f"{op}_plain")(F.spec, x, y))
            if err:
                raise AssertionError(f"{F.spec.name} {op} {tuple(x.shape)} x {tuple(y.shape)}: "
                                     f"kernel differs from plain version by {err}")
    return rows


def check_strided(F, int_rate: float) -> dict:
    """The limb-major and tiled Fr products on 2^20 elements (random, the
    edge values in the first 25 lanes) against their plain versions and,
    back in the element-major layout, against Fr ``mul``; timed.  Bound:
    the bytes of ``mul``, 3 x 64 B a product, against its 264 multiplies."""
    m = 1 << 20
    a, b = F.random((m,), 111), F.random((m,), 112)
    edge = F.array_from_ints([0, 1, F.p - 1, F.spec.r % F.p, (F.p - 1) // 2])
    a[:25], b[:25] = edge.repeat_interleave(5, dim=0), edge.repeat(5, 1)
    ref = cuda_fr.mul(F.spec, a, b)
    bound, by = _bound_ms(3 * m * F.L * 4, m * _mont_muls(F.spec.num_words), int_rate)
    rows = {}
    for name, kern, to, back in (
            ("fr_mul_limb_major", cuda_fr.mul_limb_major, exp_fieldmul.to_limb_major,
             exp_fieldmul.from_limb_major),
            ("fr_mul_tiled", cuda_fr.mul_tiled, exp_fieldmul.to_tiled, exp_fieldmul.from_tiled)):
        plain = getattr(cuda_fr, f"{kern.__name__}_plain")
        x, y = to(a), to(b)
        out = kern(F.spec, x, y)
        err = max(_equal(name, out, plain(F.spec, x, y)),
                  _equal(f"{name} against fr_mul", back(out), ref))
        rows[name] = {"shape": list(x.shape), "max_abs_err": err,
                      "ms": _ms(lambda: kern(F.spec, x, y)),
                      "plain_ms": _ms(lambda: plain(F.spec, x, y)),
                      "bound_ms": bound, "bound_by": by, "library_ms": None,
                      **cuda_fr.attributes(F.spec, kern.__name__)}
    return rows


def _phase_inputs(F, B: int, M: int):
    return F.random((B, M), 201), F.random((B, M), 202), F.random((M.bit_length() + 3,), 203)


def check_phase(F, shapes) -> int:
    """Max |kernel - plain| over every output limb (0, or it raises)."""
    for B, M in shapes:
        f, g, ch = _phase_inputs(F, B, M)
        km, kf, kg = cuda_sumcheck.product_phase(F, f, g, ch, 2)
        pm, pf, pg = cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, 2)
        torch.cuda.synchronize()
        for x, y in zip(km + [kf, kg], pm + [pf, pg]):
            err = _max_abs_err(x, y)
            if err:
                raise AssertionError(f"phase B={B} M={M}: kernel differs from plain by {err}")
    return 0


def time_phase(F, B: int, M: int, int_rate: float, plain: bool = True) -> dict:
    f, g, ch = _phase_inputs(F, B, M)
    R = M.bit_length() - 1
    out_bytes = B * (R * 3 + 2) * F.L * 4
    bound, by = _bound_ms(2 * B * M * F.L * 4 + out_bytes,
                          B * (M - 1) * 5 * _mont_muls(F.spec.num_words), int_rate)
    row = {"shape": [B, M, F.L], "ms": _ms(lambda: cuda_sumcheck.product_phase(F, f, g, ch, 0)),
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    if plain:
        row["plain_ms"] = _ms(lambda: cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, 0))
    return row


def cios_depth(words: int) -> int:
    """Dependent multiply-adds on the longest path through one CIOS product
    on ``words`` words (``fmul`` of csrc/fr.cuh): each word step
    c += a * b + t and each m = t0 * n0 counts one.  Carry-only adds and
    the final conditional subtract count nothing, so this is a lower bound."""
    t = [0] * (words + 2)  # step at which each word of t is ready
    for _ in range(words):
        c = 0
        for j in range(words):  # t += a * b_i
            c = t[j] = max(c, t[j]) + 1
        t[words] = t[words + 1] = max(c, t[words])
        c = t[0] + 2  # m = t0 * n0, then m * p0 + t0
        for j in range(1, words):  # (t + m * p) >> 32
            c = t[j - 1] = max(c, t[j]) + 1
        t[words - 1] = max(c, t[words])
        t[words] = max(t[words + 1], t[words - 1])
    return max(t[: words + 1])


def _chain_step_ms(fn, n: int) -> float:
    """Milliseconds per step of a one-thread chain: the time of 2n steps
    less that of n, over n."""
    return (_ms(lambda: fn(2 * n), reps=3) - _ms(lambda: fn(n), reps=3)) / n


def chain_latency(curve) -> tuple[float, dict]:
    """(ms, diagnostics): the least time of one Fq product along a
    thread's dependency chain, ``cios_depth(12)`` times the latency of one
    dependent 32x32->64 multiply-add measured on the card (a one-thread
    IMAD.WIDE chain, which uses no field code).  The diagnostics add what
    one product of csrc/fr.cuh takes in a one-thread chain: what this
    implementation reaches, not a bound.  Both chains' results are checked
    against host integers."""
    Fq = curve.fq
    c, y = 0x9E3779B9, 0x7F4A7C15
    xy = torch.from_numpy(np.array([c, y], dtype=np.uint32).view(np.int32)).to(curve.device)
    for _ in range(5):
        c = ((c & 0xFFFFFFFF) * y + c) & 0xFFFFFFFFFFFFFFFF
    if int(cuda_g1.imad_chain(xy, 5).item()) & 0xFFFFFFFFFFFFFFFF != c:
        raise AssertionError("imad_chain: wrong result")
    step_ms = _chain_step_ms(lambda k: cuda_g1.imad_chain(xy, k), 1 << 20)
    fxy = Fq.random((2,), 71)
    out = cuda_g1.fq_mul_chain(Fq.spec, fxy, 5)
    x, y = (int(v) for v in Fq.array_to_ints(fxy))
    if int(Fq.array_to_ints(out)) != x * pow(y, 5, Fq.p) % Fq.p:
        raise AssertionError("fq_mul_chain: wrong product")
    depth = cios_depth(Fq.spec.num_words)
    diag = {"imad_wide_latency_ns": step_ms * 1e6, "cios_depth": depth,
            "fq_product_chain_bound_us": depth * step_ms * 1e3,
            "fq_product_fmul_chain_us": _chain_step_ms(
                lambda k: cuda_g1.fq_mul_chain(Fq.spec, fxy, k), 1 << 16) * 1e3}
    return depth * step_ms, diag


def _edge_points(curve, P: PointJ, Q: PointJ):
    """(p1, p2) over P and Q [m] plus six edge lanes: an equal pair, equal
    points in other Jacobian forms, a cancelling pair, infinity on the
    left, on the right and on both sides."""
    inf = curve.infinity((1,))
    one = lambda pt, i: map_points(lambda a: a[i:i + 1], pt)  # noqa: E731
    left = [P, one(P, 0), one(P, 1), one(P, 2), inf, one(P, 3), inf]
    right = [Q, one(P, 0), curve.normalize(one(P, 1)), curve.neg(one(P, 2)), one(Q, 0), inf, inf]
    cat = lambda pts: map_points(lambda *a: torch.cat(a), *pts)  # noqa: E731
    return cat(left), cat(right)


def check_g1(curve, int_rate: float, lat_ms: float) -> dict:
    """The point ops, the scalar ladder and a forced-collision accumulate
    against their plain versions; rows keyed by kernel name."""
    spec = curve.fq.spec
    m = 1 << 16
    P = curve.double(rand_points_flat(curve, m, 61))  # random Z != 1
    Q = curve.double(rand_points_flat(curve, m, 62))
    p1, p2 = _edge_points(curve, P, Q)
    a2 = curve.normalize(p2)
    M = p1.x.shape[0]
    # lanes by case: m general, 2 doublings, 1 cancel, 3 with infinity
    # (products before the x-collision test: general 8, mixed 4)
    rows = {}
    for op, rhs, per, pre in (("add", p2, 16, 8), ("add_mixed", a2, 11, 4)):
        kern = getattr(cuda_g1, op)
        out = kern(spec, p1, rhs)
        err = _equal(f"g1 {op}", out, kern.plain(spec, p1, rhs))
        products = m * per + 2 * (pre + 7) + pre
        bound = _g1_bound(products, 9 * M * 96, ADD_DEPTH + DOUBLE_DEPTH, int_rate, lat_ms)
        rows[f"g1_{op}"] = _g1_row(op, (M, spec.num_limbs), err,
                                   _ms(lambda: kern(spec, p1, rhs)),
                                   _ms(lambda: kern.plain(spec, p1, rhs), reps=3), bound)
    err = _equal("g1 double", cuda_g1.double(spec, p1), cuda_g1.double.plain(spec, p1))
    rows["g1_double"] = _g1_row("double", (M, spec.num_limbs), err,
                                _ms(lambda: cuda_g1.double(spec, p1)),
                                _ms(lambda: cuda_g1.double.plain(spec, p1), reps=3),
                                _g1_bound(M * 7, 6 * M * 96, DOUBLE_DEPTH, int_rate, lat_ms))

    # scalar ladder: 1,024 random full-width scalars and 0, 1, r - 1
    Fr = curve.fr
    edge = np.stack([int_to_limbs(v, Fr.L) for v in (0, 1, Fr.p - 1)]).astype(np.int32)
    sc = torch.cat([Fr.decode(Fr.random((1024,), 63)), torch.from_numpy(edge).to(curve.device)])
    pts = map_points(lambda a: a[: sc.shape[0]], P)
    out = cuda_g1.scalar_mul(spec, pts, sc)
    t0 = time.perf_counter()
    ref = cuda_g1.scalar_mul.plain(spec, pts, sc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _equal("g1 scalar_mul", out, ref)
    # the add at a lane's first set bit meets infinity and costs no product
    adds = [max(bin(int(v)).count("1") - 1, 0) for v in Fr.array_to_ints(Fr.encode(sc))]
    nbits = 16 * Fr.L
    lanes = sc.shape[0]
    bound = _g1_bound(lanes * nbits * 7 + sum(adds) * 16, lanes * (2 * 288 + 4 * Fr.L),
                      nbits * DOUBLE_DEPTH + max(adds) * ADD_DEPTH, int_rate, lat_ms)
    rows["g1_scalar_mul"] = _g1_row("scalar_mul", (lanes, Fr.L), err,
                                    _ms(lambda: cuda_g1.scalar_mul(spec, pts, sc)), plain_ms,
                                    bound)

    # accumulate on a forced x-collision: bucket keys 0 and 3 hold a point twice
    bases = map_points(lambda a: a[:8], curve.normalize(P))
    dev = curve.device
    keys = torch.tensor([0, 0, 0, 1, 1, 2, 3, 3, 3, 3], dtype=torch.int64, device=dev)
    pid = torch.tensor([0, 0, 1, 2, 3, 4, 5, 5, 6, 7], dtype=torch.int64, device=dev)
    neg = torch.tensor([0, 0, 1, 0, 1, 0, 0, 0, 0, 1], dtype=torch.bool, device=dev)
    out = cuda_g1.accumulate(spec, keys, pid, neg, bases, 4, 3)
    _equal("g1 accumulate (collision)", out, cuda_g1.accumulate.plain(spec, keys, pid, neg, bases,
                                                                     4, 3))
    if out[1] <= 0:
        raise AssertionError("forced x-collision: no lane repaired")
    rows.update(check_masked(curve, int_rate, lat_ms))
    return rows, {"collision_repaired": out[1]}


def masked_inputs(curve, m: int):
    """(p1, affine p2, mask) over m random points (Z != 1) and the six edge
    lanes of ``_edge_points``: a random 0/1 mask, 1 on the edge lanes (two
    x-collisions that double, a cancel, three with infinity)."""
    P = curve.double(rand_points_flat(curve, m, 64))
    Q = curve.double(rand_points_flat(curve, m, 65))
    p1, p2 = _edge_points(curve, P, Q)
    mask = np.random.RandomState(66).randint(0, 2, size=p1.x.shape[0]).astype(bool)
    mask[m:] = True
    return p1, curve.normalize(p2), torch.from_numpy(mask).to(curve.device)


def check_masked(curve, int_rate: float, lat_ms: float) -> dict:
    """add_masked and add_reset on 2^16 random points plus the edge lanes
    against their plain versions, and timed; the bound counts 11 products
    per masked random lane (4 + 7 on a doubling lane, 4 on the cancel),
    and per lane the mask byte, the operand it copies or adds to and its
    output, with the second operand only where the mask is set."""
    spec = curve.fq.spec
    m = 1 << 16
    p1, a2, mask = masked_inputs(curve, m)
    M = p1.x.shape[0]
    products = 11 * int(mask[:m].sum()) + 2 * (4 + 7) + 4
    nbytes = M * (1 + 2 * 288) + int(mask.sum()) * 288
    rows = {}
    for op in ("add_masked", "add_reset"):
        kern = getattr(cuda_g1, op)
        err = _equal(f"g1 {op}", kern(spec, p1, a2, mask), kern.plain(spec, p1, a2, mask))
        bound = _g1_bound(products, nbytes, ADD_DEPTH + DOUBLE_DEPTH, int_rate, lat_ms)
        rows[f"g1_{op}"] = _g1_row(op, (M, spec.num_limbs), err,
                                   _ms(lambda: kern(spec, p1, a2, mask)),
                                   _ms(lambda: kern.plain(spec, p1, a2, mask), reps=3), bound)
    return rows


def time_recorded(calls, errs: dict, int_rate: float, lat_ms: float) -> dict:
    """Kernel and plain times of the first recorded accumulate, Horner and
    bucket-serial calls of the MSM paths, at the shapes the paths gave them;
    each row's error is the largest the replay of that path found."""
    rows = {}
    for key, args, _ in calls:
        name = key[3:]
        if key not in ("g1_accumulate", "g1_horner", "g1_bucket_serial") or key in rows:
            continue
        kern = getattr(cuda_g1, name)
        spec = args[0]
        if name == "accumulate":
            _, keys, pid, neg, bases, T, steps = args
            pad = torch.full((T * steps - keys.shape[0],), cuda_g1.SENTINEL, dtype=keys.dtype,
                             device=keys.device)
            lt = torch.cat([keys, pad]).reshape(T, steps).T
            adds = int(((lt[1:] == lt[:-1]) & (lt[1:] != cuda_g1.SENTINEL)).sum())
            E = keys.shape[0]
            bound = _g1_bound(adds * 11, E * 17 + bases[0].shape[0] * 288 + T * steps * 288,
                              0, int_rate, lat_ms)
            shape = (E, T, steps)
        elif name == "horner":
            tot, c = args[1], args[2]
            W, C = tot[0].shape[:2]
            bound = _g1_bound(C * (W * c * 7 + (W - 1) * 16), (W * C + C) * 288,
                              W * c * DOUBLE_DEPTH + (W - 1) * ADD_DEPTH, int_rate, lat_ms)
            shape = (W, C, c)
        else:
            K, Mb = args[1][0].shape[:2]
            bound = _g1_bound(Mb * 2 * (K - 2) * 16, K * Mb * 288, (K - 1) * ADD_DEPTH,
                              int_rate, lat_ms)
            shape = (K, Mb)
        t0 = time.perf_counter()
        kern.plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rows[key] = _g1_row(name, shape, errs[key], _ms(lambda: kern(*args)), plain_ms, bound)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the MSM paths of the prove
# ---------------------------------------------------------------------------
def _open_levels(cfg=OPEN):
    return [cfg["top"] >> k for k in range(cfg["top"].bit_length())]


def srs_bases(curve) -> dict:
    """The three paths' random bases, made as ``srs_random`` makes them."""
    out = {"c_commit": rand_points_flat(curve, COMMIT["n"], COMMIT["seeds"][0]),
           "d_commit": rand_points_flat(curve, DCOMMIT["n"], DCOMMIT["seeds"][0])}
    flat = rand_points_flat(curve, sum(_open_levels()), OPEN["seeds"][0])
    levels, off = [], 0
    for n in _open_levels():
        levels.append(map_points(lambda a, o=off, k=n: a[o:o + k], flat))
        off += n
    out["c_open"] = levels
    return out


def c_commit(curve, bases, cfg=COMMIT):
    """Leader-mode ``d_msm`` of three wire polynomials' shares over the
    packed bases (``c_commit``'s MSM).  Returns (net, run)."""
    F = curve.fr
    pp = PackedSharingParams(F, cfg["l"])
    net = PartyNet(pp.n, mode="leader")
    scal = F.decode(F.random((1, cfg["batch"], cfg["n"]), cfg["seeds"][1]))
    return net, lambda: msm_module.d_msm(curve, pp, net, bases, scal)


def d_commit(curve, bases, cfg=DCOMMIT):
    F = curve.fr
    scal = F.decode(F.random((1, cfg["batch"], cfg["n"]), cfg["seeds"][1]))
    return lambda: msm_module.msm(curve, bases, scal)


def c_open(curve, levels, cfg=OPEN):
    """``msm_ragged`` over a halving q-vector chain of three polynomials."""
    F = curve.fr
    sizes = _open_levels(cfg)
    scal = F.decode(F.random((cfg["batch"], sum(sizes)), cfg["seeds"][1]))
    chunks = list(torch.split(scal, sizes, dim=1))

    def run():
        res = msm_module.msm_ragged(curve, levels, chunks)
        return map_points(lambda *a: torch.stack(a), *res)  # [levels, batch]
    return run


# ---------------------------------------------------------------------------
# Phases 3, 5, 6: the port's sumcheck paths
# ---------------------------------------------------------------------------
def gate_identity(F, cfg=GATE):
    """Leader-mode c_sumcheck_product on the six gate-identity table pairs."""
    pp = PackedSharingParams(F, cfg["l"])
    net = PartyNet(pp.n, mode="leader")
    m_loc = (1 << cfg["n"]) // cfg["l"]
    sf, sg, sc = cfg["seeds"]
    f = F.random((1, cfg["batch"], m_loc), sf)
    g = F.random((1, cfg["batch"], m_loc), sg)
    ch = F.random((cfg["n"] + 4,), sc)
    return pp, net, (lambda: c_sumcheck_product(pp, net, f, g, ch))


def envelope(F, cfg=ENVELOPE):
    """The example's c_sumcheck_product (leader mode, its seeds)."""
    pp = PackedSharingParams(F, cfg["l"])
    net = PartyNet(pp.n, mode="leader")
    m_loc = (1 << cfg["n"]) // cfg["l"]
    sf, sg, sc = cfg["seeds"]
    f = F.random((1, m_loc), sf)
    g = F.random((1, m_loc), sg)
    ch = F.random((cfg["n"] + 4,), sc)
    return lambda: c_sumcheck_product(pp, net, f, g, ch)


def local(F, cfg=LOCAL):
    """The example's local sumcheck_product (its seeds)."""
    sf, sg, sc = cfg["seeds"]
    f = F.random((1 << cfg["n"],), sf)
    g = F.random((1 << cfg["n"],), sg)
    ch = F.random((cfg["n"] + 4,), sc)
    return lambda: sumcheck_product(F, f, g, ch)


def sim_mode(F, cfg=SIM):
    """Sim-mode c_sumcheck_product on consistent shares of all 8l parties.

    Returns (net, opened proof ints, local proof tensor, challenge ints, h)."""
    pp = PackedSharingParams(F, cfg["l"])
    net = PartyNet(pp.n, mode="sim")
    M = 1 << cfg["n"]
    sf, sg, sc = cfg["seeds"]
    f = F.random((M,), sf)
    g = F.random((M,), sg)
    ch = F.random((cfg["n"] + 4,), sc)

    def shares(x):  # [M, L] -> [N, M/l, L] party-major shares
        return pp.pack_from_public(x.reshape(M // pp.l, pp.l, F.L)).movedim(-2, 0)

    msgs = c_sumcheck_product(pp, net, shares(f), shares(g), ch)  # [N, R, 3, L]
    opened = F.sum(pp.unpack2(msgs.movedim(0, -2)), axis=-2)  # [R, 3, L]
    mono = sumcheck_product(F, f, g, ch)
    h = int(F.array_to_ints(F.sum(F.mul(f, g), axis=0)))
    return net, opened, mono, [int(v) for v in F.array_to_ints(ch)], h


def _comm(net: PartyNet):
    return (net.up[0], net.down[0], net.up[1], net.down[1], net.rounds)


def _check_pin(name: str, got):
    if got != PINS[name]:
        raise AssertionError(f"{name}: got {got!r}, pinned {PINS[name]!r}")


class _Recorder:
    """Stands in for a module of the port while the main path runs: every
    attribute is the module's own, and each call to one of ``names`` is
    appended to ``calls`` as (prefix + name, arguments, result): the
    kernel's name in the kernel table, or, given ``keep``, handed to
    ``keep(calls, entry)``, which files the entries it samples.  It launches
    nothing itself, so the wrappers' launch counts are unchanged."""

    def __init__(self, module, prefix: str, names, calls: list, keep=None):
        self._module = module
        keep = keep or list.append
        for name in names:
            setattr(self, name, self._keep(prefix + name, getattr(module, name), calls, keep))

    @staticmethod
    def _keep(name, fn, calls, keep):
        def call(*args):
            out = fn(*args)
            keep(calls, (name, args, out))
            return out
        return call

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def recording():
    """Keep every field-, phase- and G1-kernel call the port makes inside
    the block (the ``Field`` ops, the sumcheck rounds, the ``Curve`` ops
    and the MSM reach the kernels only through these module references)."""
    calls = []
    fr_module.cuda_fr = _Recorder(cuda_fr, "fr_", ("mul", "add", "sub"), calls)
    sumcheck_module.cuda_sumcheck = _Recorder(cuda_sumcheck, "sumcheck_", ("product_phase",), calls)
    g1_module.cuda_g1 = msm_module.cuda_g1 = _Recorder(cuda_g1, "g1_", G1_WRAPPERS, calls)
    try:
        yield calls
    finally:
        fr_module.cuda_fr, sumcheck_module.cuda_sumcheck = cuda_fr, cuda_sumcheck
        g1_module.cuda_g1 = msm_module.cuda_g1 = cuda_g1


def replay(calls) -> tuple[dict, dict]:
    """Each recorded call's result against the plain version on the same
    operands.  Returns ({kernel: calls replayed}, {kernel: largest
    difference found}); raises on any difference."""
    seen, errs = {}, {}
    for key, args, out in calls:
        if key.startswith("g1_"):
            try:
                err = _equal(key, out, getattr(cuda_g1, key[3:]).plain(*args))
            except AssertionError as exc:
                shape = tuple(args[1][0].shape)
                raise AssertionError(f"{exc} at {shape} on the main path") from None
            seen[key] = seen.get(key, 0) + 1
            errs[key] = max(errs.get(key, 0), err)
            continue
        if key == "sumcheck_product_phase":
            F, f, g, ch, start = args
            ref = cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, start)
            pairs = list(zip(out[0] + [out[1], out[2]], ref[0] + [ref[1], ref[2]]))
            shapes = (tuple(f.shape), tuple(g.shape))
        else:
            spec, a, b = args
            pairs = [(out, getattr(cuda_fr, f"{key[3:]}_plain")(spec, a, b))]
            shapes = (tuple(a.shape), tuple(b.shape))
        err = max(_max_abs_err(x, y) for x, y in pairs)
        if err:
            raise AssertionError(f"{key} at {shapes} on the main path: kernel differs "
                                 f"from plain version by {err}")
        seen[key] = seen.get(key, 0) + 1
        errs[key] = max(errs.get(key, 0), err)
    return seen, errs


def _wrappers() -> dict:
    out = {"fr_mul": cuda_fr.mul, "fr_add": cuda_fr.add, "fr_sub": cuda_fr.sub,
           "sumcheck_product_phase": cuda_sumcheck.product_phase,
           "fr_mul_limb_major": cuda_fr.mul_limb_major, "fr_mul_tiled": cuda_fr.mul_tiled}
    out.update({f"g1_{n}": getattr(cuda_g1, n) for n in G1_WRAPPERS})
    return out


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


@contextlib.contextmanager
def _env(name: str, value):
    """``name`` set to ``value`` (or unset, with None) inside the block,
    restored after it."""
    before = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if before is not None:
            os.environ[name] = before


def msm_config(dense: bool):
    """The MSM configuration of the block: the dense core, or with
    ``SCZK_MSM_DENSE=0`` the non-dense cores (read at each MSM call)."""
    return _env("SCZK_MSM_DENSE", None if dense else "0")


def mxu_config():
    """The int8-engine configuration of the block: ``SCZK_MXU=1`` (read at
    each round loop), every product and single sumcheck on
    ``mxu_sumcheck``."""
    return _env("SCZK_MXU", "1")


class _LoopEnds:
    """A ``keep`` for ``_Recorder`` that files the first and the last call
    of every chained loop: a loop's steps chain, each taking the last
    step's result as its first operand, so a call whose first operand is
    not the previous result starts a loop."""

    def __init__(self):
        self.last = None

    def __call__(self, calls: list, entry):
        prev = self.last
        if prev is None or entry[1][1][0] is not prev[2][0]:
            self.close(calls)
            calls.append(entry)
        self.last = entry

    def close(self, calls: list):
        if self.last is not None and calls[-1] is not self.last:
            calls.append(self.last)


@contextlib.contextmanager
def sampling_masked():
    """Keep the first and the last ``add_masked`` call of every bucket loop
    in the block, as (kernel name, arguments, result)."""
    kept, ends = [], _LoopEnds()
    g1_module.cuda_g1 = _Recorder(cuda_g1, "g1_", ("add_masked",), kept, keep=ends)
    try:
        yield kept
    finally:
        g1_module.cuda_g1 = cuda_g1
        ends.close(kept)


def prove_phase(launches: dict, replayed: dict) -> dict:
    """The main path: ``dhyperplonk`` at n = 16, l = 8, leader mode, through
    the bench entry (setup, warm-up, three synchronised proves, one with
    synchronised spans), its digest and comm against the pins, then one
    prove counted on its own in each MSM configuration.  The non-dense
    prove's first and last ``add_masked`` step of every loop is replayed
    through the plain version."""
    n, l = PROVE["n"], PROVE["l"]
    report, (pk, net, _) = bench_module.run(n, l, "cuda", repeat=3)
    _check_pin(f"prove_n{n}_l{l}", int(report["digest"], 16))
    for dense in (True, False):
        key = "prove" if dense else "prove_nondense"
        with msm_config(dense), (contextlib.nullcontext([]) if dense else sampling_masked()) as kept:
            net.reset_comm()
            _reset_counts()
            t0 = time.perf_counter()
            out = dhyperplonk(n, pk, net)
            torch.cuda.synchronize()
            report[f"{key}_s"] = time.perf_counter() - t0
            launches[key] = _counts()
        _check_pin(f"prove_n{n}_l{l}_comm", _comm(net))
        _check_pin(f"prove_n{n}_l{l}", proof_digest(pk.curve, out))
        report[f"{key}_launches"] = {k: v for k, v in launches[key].items() if v}
        del out
    replayed["prove_nondense"], errs = replay(kept)
    report["add_masked_steps_replayed"] = len(kept)
    report["add_masked_replay_max_abs_err"] = errs["g1_add_masked"]
    report["comm_pinned"] = list(PINS[f"prove_n{n}_l{l}_comm"])
    del kept
    report.update(mxu_prove(pk, net, n, launches))
    report["profile"] = profile_prove(pk, net, n)
    del pk
    return report


def mxu_prove(pk, net, n: int, launches: dict, repeat: int = 3) -> dict:
    """The (n, l) prove with ``SCZK_MXU=1``: a warm-up, then ``repeat``
    synchronised proves, each with the counts set to 0 just before it, so
    the last one's launches and int8 products are those of one prove; its
    digest and comm against the pins."""
    key = f"prove_n{n}_l{pk.pp.l}"
    runs = []
    with mxu_config():
        dhyperplonk(n, pk, net)
        torch.cuda.synchronize()
        for _ in range(repeat):
            net.reset_comm()
            _reset_counts()
            mxu.matmuls = 0
            t0 = time.perf_counter()
            out = dhyperplonk(n, pk, net)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        launches["prove_mxu"] = _counts()
        matmuls = mxu.matmuls
    _check_pin(f"{key}_comm", _comm(net))
    _check_pin(key, proof_digest(pk.curve, out))
    if not matmuls or launches["prove_mxu"]["sumcheck_product_phase"]:
        raise AssertionError(f"the SCZK_MXU prove made {matmuls} int8 products and "
                             f"{launches['prove_mxu']['sumcheck_product_phase']} phase launches")
    return {"prove_mxu_s": statistics.median(runs), "prove_mxu_runs": runs,
            "prove_mxu_int8_matmuls": matmuls,
            "prove_mxu_launches": {k: v for k, v in launches["prove_mxu"].items() if v}}


def profile_prove(pk, net, n: int) -> dict:
    """One dense prove under ``torch.profiler`` (host and CUDA activity):
    the device time summed over every kernel and copy, its share of the
    same prove's wall time, and the kernels that took most of it.  The
    ``timed`` spans' ranges, which the profiler also reports with device
    time, are left out.  Without device events the share is None: not
    measured."""
    torch.cuda.synchronize()
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dhyperplonk(n, pk, net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {label.replace(" ", "_") for label, _ in timer.records()}
    events = [e for e in prof.key_averages() if e.key not in spans]
    name = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")  # the name before torch 2.4
    dev = lambda e: getattr(e, name)  # noqa: E731
    kern = sorted(((e.key, dev(e) / 1e6, e.count) for e in events if dev(e) > 0),
                  key=lambda t: -t[1])
    busy = sum(t for _, t, _ in kern)
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if kern else None,
            "top_device_s": [[k, t, c] for k, t, c in kern[:12]]}


def small_prove() -> dict:
    """The (6, 1) leader-mode prove in both MSM configurations and with
    ``SCZK_MXU=1``, pinned."""
    n, l = SMALL_PROVE["n"], SMALL_PROVE["l"]
    net = PartyNet(8 * l, mode="leader")
    pk = packed_proving_parameters(n, l, net)
    digests = {}
    for name, config in (("dense", msm_config(True)), ("nondense", msm_config(False)),
                         ("mxu", mxu_config())):
        with config:
            digests[name] = d = proof_digest(pk.curve, dhyperplonk(n, pk, net))
        _check_pin(f"prove_n{n}_l{l}", d)
    return {k: f"0x{v:016x}" for k, v in digests.items()}


def mxu_paths(F, launches: dict) -> dict:
    """The gate identity with ``SCZK_MXU=1``, counted on its own, against
    its pin; ``mxu_sumcheck.product_phase`` against the fold-phase kernel on
    the ``[6, 2^13]`` tables of phase 2 (bit for bit), both timed."""
    _, _, gate = gate_identity(F)
    with mxu_config():
        _reset_counts()
        mxu.matmuls = 0
        proof = gate()
        torch.cuda.synchronize()
        launches["gate_identity_mxu"] = _counts()
        out = {"gate_identity_mxu_int8_matmuls": mxu.matmuls,
               "gate_identity_mxu_ms": _host_ms(gate, 3)}
    _check_pin("gate", limb_digest(proof))
    f, g, ch = _phase_inputs(F, 6, 1 << 13)
    out["product_phase_max_abs_err"] = _equal(
        "mxu_sumcheck.product_phase", mxu_sumcheck.product_phase(F, f, g, ch, 2),
        cuda_sumcheck.product_phase(F, f, g, ch, 2))
    out["product_phase_6x2e13_mxu_ms"] = _host_ms(
        lambda: mxu_sumcheck.product_phase(F, f, g, ch, 0), 3)
    out["product_phase_6x2e13_kernel_ms"] = _host_ms(
        lambda: cuda_sumcheck.product_phase(F, f, g, ch, 0), 3)
    return out


def fieldmul_path(launches: dict) -> list[dict]:
    """``scripts/exp_fieldmul.py``'s ``run`` at 2^20, counted on its own:
    the four formulations must match and the product equal the JAX-made
    pin."""
    _reset_counts()
    rows = exp_fieldmul.run(20, "cuda")
    torch.cuda.synchronize()
    launches["exp_fieldmul"] = _counts()
    bad = [r["name"] for r in rows if not r["match"]]
    if bad:
        raise AssertionError(f"exp_fieldmul: {bad} differ from A")
    _check_pin("exp_fieldmul", rows[0]["digest"])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    # 1. build
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    print(json.dumps({"build_s": build_s, "wall_s": time.perf_counter() - t0}), flush=True)

    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    int_rate = props.multi_processor_count * IMAD_PER_SM_CLOCK * clock_mhz * 1e6
    print(json.dumps({"sms": props.multi_processor_count, "max_sm_clock_mhz": clock_mhz,
                      "int_mul_per_s": int_rate}), flush=True)
    F = get_field(FIELD)
    Fq = get_field("bls12_381_fq")

    # 2. kernels against their plain versions
    fr_rows = check_elementwise(F, 1 << 20, int_rate)
    strided_rows = check_strided(F, int_rate)
    fq_rows = check_elementwise(Fq, 1 << 20, int_rate)
    phase_err = check_phase(F, [(B, M) for B in (1, 6) for M in (2, 128, 1 << 13)])
    phase_row = dict(time_phase(F, 6, 1 << 13, int_rate), max_abs_err=phase_err)
    phase_big = [time_phase(F, 1, 1 << k, int_rate, plain=False) for k in (21, 25)]
    print(json.dumps({"fq_instances": fq_rows}), flush=True)
    print(json.dumps({"phase_large": phase_big}), flush=True)

    # G1 kernels against their plain versions (phase 2, continued)
    curve = bls12_381_g1()
    lat_ms, chain_diag = chain_latency(curve)
    g1_rows, collision = check_g1(curve, int_rate, lat_ms)
    print(json.dumps({**chain_diag, **collision}), flush=True)

    # 3. the sumcheck main path, with launch counts around one call, whose
    # kernel calls are then replayed through the plain versions
    _, net, gate = gate_identity(F)
    with recording() as calls:
        _reset_counts()
        proof = gate()
        torch.cuda.synchronize()
        launches = {"gate_identity": _counts()}
    _check_pin("gate", limb_digest(proof))
    replayed = {"gate_identity": replay(calls)[0]}
    del calls
    for name in ("fr_mul", "fr_add", "fr_sub"):
        if replayed["gate_identity"].get(name, 0) != launches["gate_identity"][name]:
            raise AssertionError(f"{name}: {launches['gate_identity'][name]} launches, "
                                 f"{replayed['gate_identity'].get(name, 0)} calls replayed")
    print(json.dumps({"main_path_replayed": replayed["gate_identity"]}), flush=True)
    paths = {"gate_identity_ms": _host_ms(gate, 5), "gate_comm": list(net.comm(0))}

    # 4. the MSM paths of the prove, each counted on its own
    _reset_counts()
    bases = srs_bases(curve)
    torch.cuda.synchronize()
    launches["srs_bases"] = _counts()
    _check_pin("commit_bases", point_digest(curve, bases["c_commit"]))
    net, run_a = c_commit(curve, bases["c_commit"])
    runs = {"c_commit": run_a, "d_commit": d_commit(curve, bases["d_commit"]),
            "c_open": c_open(curve, bases["c_open"])}
    g1_times = {}
    for name, run in runs.items():
        record = name != "d_commit"
        with (recording() if record else contextlib.nullcontext([])) as calls:
            _reset_counts()
            out = run()
            torch.cuda.synchronize()
            launches[name] = _counts()
        _check_pin(name, point_digest(curve, out))
        if name == "c_commit":
            _check_pin("c_commit_comm", _comm(net))
        if record:
            replayed[name], errs = replay(calls)
            for key, n in launches[name].items():
                if key != "sumcheck_product_phase" and replayed[name].get(key, 0) != n:
                    raise AssertionError(f"{name}: {key} launched {n} times, "
                                         f"{replayed[name].get(key, 0)} calls replayed")
            g1_times[name] = time_recorded(calls, errs, int_rate, lat_ms)
        del calls, out
        paths[f"{name}_ms"] = _host_ms(run, 3)
        paths[f"{name}_launches"] = {k: v for k, v in launches[name].items() if v}
        with msm_config(dense=False):  # the non-dense cores, the same pin
            _reset_counts()
            out = run()
            torch.cuda.synchronize()
            launches[f"{name}_nondense"] = _counts()
            paths[f"{name}_nondense_ms"] = _host_ms(run, 1)
        _check_pin(name, point_digest(curve, out))
        del out
    print(json.dumps({"msm_replayed": {k: replayed[k] for k in ("c_commit", "c_open")},
                      "msm_timed_at_path_shapes": g1_times}), flush=True)
    del bases, runs, run_a
    g1_rows.update(g1_times["c_commit"])
    g1_rows["g1_bucket_serial"] = g1_times["c_open"]["g1_bucket_serial"]

    # 5. the main path: the prove at n = 16, l = 8 in both MSM
    # configurations, and the (6, 1) prove
    prove = prove_phase(launches, replayed)
    prove["n6_l1_digests"] = small_prove()
    print(json.dumps({"prove": prove}), flush=True)
    print(json.dumps({"mxu": mxu_paths(F, launches)}), flush=True)
    micro = mxu_micro.run("cuda")
    if not micro[4]["equal_to_mxu"]:
        raise AssertionError("mxu_micro: the int8 product phase differs from the phase kernel")
    print(json.dumps({"mxu_micro": micro}), flush=True)
    print(json.dumps({"exp_fieldmul": fieldmul_path(launches)}), flush=True)

    # 6. the reference's sumcheck envelope
    run = envelope(F)
    _reset_counts()
    _check_pin("envelope", limb_digest(run()))
    paths["c_sumcheck_product_n26_l32_launches"] = {k: v for k, v in _counts().items() if v}
    paths["c_sumcheck_product_n26_l32_ms"] = _host_ms(run, 3)
    run = local(F)
    _check_pin("local", limb_digest(run()))
    paths["sumcheck_product_n20_ms"] = _host_ms(run, 3)
    del run
    top = envelope(F, TOP)
    paths["c_sumcheck_product_n30_l32_ms"] = _host_ms(top, 2)
    del top

    # 7. sim mode, self-verifying
    net, opened, mono, ch_ints, h = sim_mode(F)
    proof_ints = [tuple(int(v) for v in row) for row in F.array_to_ints(opened)]
    if not check_sumcheck_product(F, h, proof_ints, ch_ints):
        raise AssertionError("sim-mode transcript fails check_sumcheck_product")
    if not torch.equal(opened, mono):
        raise AssertionError("sim-mode opened transcript differs from the local one")
    _check_pin("sim_comm", _comm(net))
    paths["sim_comm"] = list(_comm(net))
    print(json.dumps({"paths": paths}), flush=True)

    # 8. kernel table: launches summed over the paths (gate identity, SRS
    # bases, c_commit, d_commit, c_open, each also non-dense, the prove in
    # both MSM configurations and with SCZK_MXU=1, the SCZK_MXU gate
    # identity, exp_fieldmul), each counted on its own
    zero = [k for k in KERNELS
            if not launches["gate_identity"][k] or not replayed["gate_identity"].get(k)]
    msm_paths = ("srs_bases", "c_commit", "d_commit", "c_open")
    zero += [k for k in MSM_PATH_KERNELS if not sum(launches[p][k] for p in msm_paths)]
    zero += [f"{k} (prove)" for k in PROVE_DENSE_KERNELS if not launches["prove"][k]]
    zero += [f"{k} (non-dense prove)" for k in PROVE_NONDENSE_KERNELS
             if not launches["prove_nondense"][k]]
    zero += [f"{k} (SCZK_MXU prove)" for k in PROVE_MXU_KERNELS if not launches["prove_mxu"][k]]
    zero += [f"{k} (exp_fieldmul)" for k in FIELDMUL_KERNELS if not launches["exp_fieldmul"][k]]
    if zero:
        raise AssertionError(f"kernels not launched on the main paths: {zero}")
    rows = {f"fr_{r['op']}": dict(r, **cuda_fr.attributes(F.spec, r["op"])) for r in fr_rows}
    phase_attrs = cuda_sumcheck.attributes()
    rows["sumcheck_product_phase"] = dict(phase_row, **phase_attrs["round"],
                                          partial_reduce=phase_attrs["partial_reduce"])
    rows.update(g1_rows)
    rows.update(strided_rows)
    kernels = []
    for name, (source, replaces) in {**KERNELS, **FIELDMUL_KERNELS, **G1_KERNELS}.items():
        r = rows[name]
        by_path = {p: n[name] for p, n in launches.items() if n[name]}
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "launches_by_path": by_path,
            "main_path_calls_replayed": sum(v.get(name, 0) for v in replayed.values()),
            "registers": r["registers"], "spill_bytes": r["spill_bytes"],
        }
        if "bound_kind" in r:
            row["bound_kind"] = r["bound_kind"]
        if name in OFF_PATH:
            row["note"] = OFF_PATH[name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
