#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit; build every kernel from
   ``scalable_collaborative_zksnark_tpu_torch/csrc`` (one ``nvcc`` each,
   in parallel);
2. hold each kernel (Fr mul/add/sub, the Fq instances, each also on
   operands read through their strides (``binary_cases``: a transposed
   view, a stepped slice, middle broadcasts, an outer product, a
   misaligned base, the edge values 0, 1, p - 1, R mod p and (p - 1) / 2)
   in small and staged launches, none of them copied, and timed at 2^20
   by device time, staged and not; the limb-major
   and tiled Fr products on 2^20 elements, also against Fr mul after the
   layout transform; the sumcheck fold phase at every table shape the
   (16, 8) prove folds, M = 2 and 4, every cluster size, head rounds and
   [1, 2^21] (its own plan of launches each), on tables and challenges holding 0, 1 and p - 1, timed
   (events and device time) at [6, 2^13], [1, 2^21] and [1, 2^25]; the
   carry-chain Fr product against Fr mul on 2^16 pairs and edge values,
   with its one-thread chain latency beside fmul<8>'s; the G1 point ops on 2^16
   points and an edge set, ``add_masked`` and ``add_reset`` there under a
   random mask, masks of all 0s, all 1s and alternating, the scalar ladder
   on 1,024 full scalars and 0, 1, r - 1, on a warp whose teams diverge
   and on 2-limb scalars, the accumulate on a forced x-collision, on a
   warp whose teams diverge and on random keys over two staging chunks) bit for bit against
   its plain PyTorch version on the card, and time both (CUDA events,
   median of 10 or more for the kernels; ``add_mixed`` and ``double`` on
   their team kernel also by device time); print each kernel's registers
   and spill bytes, and the latency of one dependent multiply-add (a
   one-thread chain) that the chain bounds of Horner, bucket-serial and
   the ladder are built on; the low-latency product of Horner and
   bucket-serial (``csrc/fq_chain.cuh``) against Fq mul on 2^16 pairs
   and edge values, with its one-thread chain latency; Horner and
   bucket-serial on an edge grid (collisions that double and cancel,
   infinities, K = 2, several segment counts);
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
   digest and comm against the JAX-made pins; every phase call of the
   dense prove replayed through the plain version (one launch a call, at
   most 16 a prove); the non-dense prove's first
   and last ``add_masked`` step of every bucket loop replayed through the
   plain version; one more prove in each MSM configuration under
   ``torch.profiler`` (device time by kernel, each team kernel's, the
   device's busy share); one dense prove whose point-add, Horner,
   bucket-serial and ladder call shapes are kept (histograms; ``add`` held
   against its plain version at every lane count it saw, with edge lanes
   at 3 and 8,192, and timed at the four most frequent; the ladder held
   and timed at every shape it saw) and one non-dense prove whose
   ``add_masked`` lane counts are kept (held and timed at the four most
   frequent); one dense prove whose every Fr and Fq mul/add/sub call is
   kept with its operands as laid out and replayed through the plain
   version (bit equality), counted by kernel instance and size, and each
   (field, op)'s three commonest shapes timed on a kept call's own
   operands (device time a launch, also in a small and a staged launch,
   beside its bound there, the product's chain bound and the device time
   of an empty launch); the operands the elementwise wrapper
   copied in the dense prove (``cuda_fr.copies``, which must be 0); the dense
   prove must launch point add 854, the accumulate 15, Horner 15,
   bucket-serial 12 and the ladder 3 times, the non-dense one
   ``add_masked`` 1,755 and the ladder 3, the SRS bases the ladder 6; the (6, 1) prove in both
   configurations, pinned; the int8-engine configuration (``SCZK_MXU=1``):
   the gate identity against its pin, ``mxu_sumcheck.product_phase``
   against the fold-phase kernel on ``[6, 2^13]`` tables, the (16, 8)
   prove (warm-up and three timed proves, the last counted on its own:
   launches and int8 products) and the (6, 1) prove, pinned;
   ``scripts/mxu_micro.py``'s rows at its sizes;
   the ``scripts/exp_fieldmul.py`` path at 2^20 with its counts set to 0
   just before it: four formulations equal, both strided kernels
   launched, the product pinned;
5b. the (16, 8) benchmark SRS through the disk cache (``SCZK_SRS_CACHE``
   on a temporary directory): build, write, file size and load timed,
   every loaded point equal to the built one, and a
   ``packed_proving_parameters`` call that must load it proving the
   flagship pin and comm; ``bench --conformance`` (the (6, 1) prove)
   must print PASS; the measurement
   scripts once each, their output parsed: ``pin_digest`` at (16, 8)
   prints the pin, ``sweep --suite hyperplonk --n 10 --l 2`` writes its
   CSV, ``profile_primitives`` at (16, 8) and ``g1_micro`` time every row;
6. the reference's sumcheck envelope, l = 32, with the seeds of
   ``examples/sumcheck.py``: ``c_sumcheck_product`` at n = 26 (pinned),
   local ``sumcheck_product`` at n = 20 (pinned), ``c_sumcheck_product``
   at n = 30 (timed only);
7. sim mode, l = 4 (32 parties), n = 20, shares from ``pack_from_public``:
   the opened transcript must pass ``check_sumcheck_product`` and equal the
   local transcript, and the party-net counters must equal the pins;
8. the protocol layer at n = 16, l = 8, each step with the counts set
   to 0 just before it and read just after, its host seconds, launches per
   kernel and peak device memory printed on a line of its own:
   (a) honest SRSs of 18 variables built on the card (d with 64 parties'
   weights and root levels, c plain, c packed for l = 8) from
   tests/test_hyperplonk.py's secret seeds; every point of the levels up
   to 6 and of the root levels, and 64 seeded points of each higher level,
   equal to G1_GEN times the point's scalar on the host (the first of each
   level by ``host_curve.g1_mul``, the rest by a fixed-base table of the
   host's affine adds), and the top level's ladder on 4,096 lanes held
   against its plain version;
   (b) ``dhyperplonk`` in sim mode with all 64 parties on the card, on
   consistent shares with those SRSs, then three more synchronised
   proves timed (median), as (b2) times its split proves:
   ``verify_dhyperplonk`` with its
   pairings must fail exactly the three c_open pairings (at l > 1 their
   last log2(l) proofs are the reference's local MSMs over the packed
   base, dpoly_comm.rs:454-456; the JAX package's verifier reports the
   same) and accept it without pairings (prove, device-side and pairing
   seconds apart), and a copy with one gate message changed must fail
   naming gate[1]; then the same at l = 1 (8 parties) on SRSs of the
   same secrets, which the complete verifier with its pairings accepts;
   (b2) the same (16, 8) prove with its 64 parties spread over ranks
   (``split_world``: four NCCL ranks, one a card, with four cards or more,
   two with two or three, four gloo ranks sharing the card with one),
   started with ``spawn`` on the kernels built in phase 1: each rank loads
   (a)'s SRSs from a temporary file (its rows of the packed levels, cut on
   the host), builds its rows of (b)'s consistent inputs and proves its
   parties' share, three synchronised proves (median) after a warm-up and
   one counted: rank 0's gathered bundle must have (b)'s digest, every
   rank's comm (b)'s, and every rank must launch each kernel of the sim
   prove; then ``dhyperplonk_data_parallel``, ``dpermcheck`` and
   ``cpermcheck`` at (12, 2) in the same world, each against its
   single-process sim digest and comm made first; one JSON line gives
   the world, backend, cards, any collective staged through host memory,
   each rank's prove seconds and peak memory, the digest and the comm;
   (c) ``local_hyperplonk`` and ``local_hyperplonkpp`` at n = 16 on
   ``srs_random(curve, 18, 7)``, median of three synchronised proves after a
   warm-up, digests pinned, one prove each with ``SCZK_MXU=1`` pinned, and
   ``local_hyperplonk`` on the honest c-SRS of (a), which
   ``verify_local_hyperplonk`` must accept;
   (d) ``dhyperplonk_data_parallel``, ``dpermcheck`` and ``cpermcheck`` at
   (16, 8) in leader mode, median of three after a warm-up, digest and comm
   of one prove pinned, then one prove of each with ``SCZK_MSM_DENSE=0``
   and one with ``SCZK_MXU=1``, each counted on its own, against the same
   pins.  The (16, 8) sim prove of (b) also runs once with
   ``SCZK_MSM_DENSE=0`` and once with ``SCZK_MXU=1``, each counted on its
   own, to the default prove's bundle and comm.  Of each counted prove
   and of the (16, 8) verifier run, the first field- and phase-kernel
   call at each operand layout is replayed through the plain version, and
   in the local prove and the verifier also the first call of each G1
   kernel (the variants' G1 calls have the flagship prove's shapes);
9. print the kernel table (one JSON line) and last
   ``{"ok": true, "device": {...}}``.

The pins (sha256 of the little-endian uint32 limb bytes, of normalized
points for the MSM paths, the proves' canonical 64-bit digests, and the
comm counters) were made from the JAX package on the CPU with the same
seeds and the same digest code, by ``test_chip_smoke_pins`` in
``tests/test_torch_sumcheck.py``, ``test_chip_smoke_msm_pins`` in
``tests/test_torch_msm.py``, ``test_chip_smoke_prove_pins`` in
``tests/test_torch_hyperplonk.py``, ``test_chip_smoke_fieldmul_pin`` in
``tests/test_torch_fieldmul.py`` and ``test_chip_smoke_protocol_pins`` in
``tests/test_torch_protocol_slow.py`` (marked slow), which recompute and
check them.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scalable_collaborative_zksnark_tpu_torch import bench as bench_module
from scalable_collaborative_zksnark_tpu_torch import cuda_build
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu_torch.curves import g1 as g1_module
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1, map_points
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr
from scalable_collaborative_zksnark_tpu_torch.fields import fr as fr_module
from scalable_collaborative_zksnark_tpu_torch.fields import mxu
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import (cpermcheck, dhyperplonk,
                                                                  dhyperplonk_data_parallel,
                                                                  dpermcheck, local_hyperplonk,
                                                                  local_hyperplonkpp, local_inputs,
                                                                  packed_proving_parameters,
                                                                  verify_local_hyperplonk)
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative as collab_module
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import params as params_module
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import sharding
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import eq_top_table
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import (
    consistent_proving_parameters)
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.verify import (verify_dhyperplonk,
                                                                        verify_dhyperplonk_gate)
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import msm as msm_module
from scalable_collaborative_zksnark_tpu_torch.primitives import mxu_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck as sumcheck_module
from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import (rand_points_flat,
                                                                          srs_from_secret,
                                                                          srs_random)
from scalable_collaborative_zksnark_tpu_torch.primitives.sumcheck import (
    c_sumcheck_product,
    check_sumcheck_product,
    sumcheck_product,
)
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.scripts import (exp_fieldmul, g1_micro, mxu_micro,
                                                               pin_digest, profile_primitives,
                                                               sweep)
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
    # phase 8: the local provers at n = 16 on srs_random(curve, 18, 7)
    # (examples/hyperplonk.py's) and the three variants at (16, 8) in
    # leader mode: canonical digests and (up[0], down[0], up[1], down[1],
    # rounds) of one prove
    "local_n16": 0x3F383B6CD10547C8,
    "localpp_n16": 0x17F6C15A03FE531F,
    "dp_n16_l8": 0x0F5187531F18DCE8,
    "dp_n16_l8_comm": (2271025, 2897497, 45993, 36049, 67),
    "dperm_n16_l8": 0x0E93564EE605642F,
    "dperm_n16_l8_comm": (2769985, 3662569, 1074441, 1060273, 117),
    "cperm_n16_l8": 0xA9CA3AF5B5BBF6FD,
    "cperm_n16_l8_comm": (24654169, 21474937, 8407817, 8458281, 559),
}
# The main path: dhyperplonk in leader mode at the JAX package's flagship
# size, and the small size its CPU tests pin.
PROVE = {"n": 16, "l": 8}
SMALL_PROVE = {"n": 6, "l": 1}
# Phase 8, the protocol layer at the flagship size: honest SRSs of n + 2
# variables from tests/test_hyperplonk.py's secret seeds (d for 8l parties,
# c plain and packed for l), the sim-mode prove with all 8l parties on the
# card, the local provers on srs_random(curve, n + 2, 7) and the three
# variants in leader mode
PROTOCOL = {"n": 16, "l": 8, "srs_seeds": {"d": 31, "c": 37}, "local_srs_seed": 7}
SRS_FULL_LEVELS = 6  # every point of the levels up to this one checked on the host
SRS_SAMPLED = 64  # seeded points checked at each higher level
LADDER_SLICE = 4096  # lanes of the SRS's top-level ladder held against the plain version
# kernels each protocol path must launch
SRS_KERNELS = ("fr_mul", "g1_scalar_mul")
SRS_PACKED_KERNELS = ("fr_mul", "fr_add", "g1_scalar_mul")
VERIFY_KERNELS = ("fr_mul", "fr_add", "fr_sub", "g1_scalar_mul", "g1_add")
PROTOCOL_PROVE_KERNELS = ("fr_mul", "fr_add", "fr_sub", "sumcheck_product_phase", "g1_add",
                          "g1_accumulate", "g1_horner")
# what the verifier reports on a sim bundle at l > 1: the c_opens' phase-2
# proofs are local MSMs over the packed base (the reference's stated
# simplification, dpoly_comm.rs:454-456), so their pairings fail, in the
# JAX package's verifier too
C_OPEN_PHASE2_FAILURES = [f"c_open[{p}]: pairing check" for p in "abc"]
LOCAL_PROVERS = {"local": local_hyperplonk, "localpp": local_hyperplonkpp}
VARIANTS = {"dp": dhyperplonk_data_parallel, "dperm": dpermcheck, "cperm": cpermcheck}
# the split phase: the timed proves of the (16, 8) prove, the variants' (n, l),
# and the most seconds the ranks may take together
SPLIT = {"repeat": 3, "n": 12, "l": 2, "timeout_s": 600}
# the kernels a phase-8 prove must launch in each engine configuration
# other than the default: the non-dense MSM cores and the int8 engine
CONFIG_PROVE_KERNELS = {
    "nondense": tuple(k for k in PROTOCOL_PROVE_KERNELS if k != "g1_accumulate")
    + ("g1_add_masked",),
    "mxu": tuple(k for k in PROTOCOL_PROVE_KERNELS if k != "sumcheck_product_phase"),
}
# the measurement scripts' runs on the card: sweep's cells
SWEEP = {"suite": "hyperplonk", "n": 10, "l": 2}

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
_G1_CHAIN_SRC = "scalable_collaborative_zksnark_tpu_torch/csrc/g1_chain.cu"
_PALLAS_G1 = "scalable_collaborative_zksnark_tpu/curves/pallas_g1.py"
G1_KERNELS = {
    "g1_add": (_G1_SRC, f"{_PALLAS_G1}:129"),
    "g1_add_mixed": (_G1_SRC, f"{_PALLAS_G1}:129"),
    "g1_double": (_G1_SRC, f"{_PALLAS_G1}:200"),
    "g1_accumulate": (_G1_SRC, f"{_PALLAS_G1}:180"),
    "g1_scalar_mul": (_G1_SRC, f"{_PALLAS_G1}:207"),
    "g1_horner": (_G1_CHAIN_SRC, f"{_PALLAS_G1}:358"),
    "g1_bucket_serial": (_G1_CHAIN_SRC, f"{_PALLAS_G1}:497"),
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
# point add, accumulate, Horner and bucket-serial launches of one dense
# (16, 8) prove
PROVE_G1_LAUNCHES = {"g1_add": 854, "g1_accumulate": 15, "g1_horner": 15, "g1_bucket_serial": 12,
                     "g1_scalar_mul": 3}
# the ladder and masked-add launches of one non-dense (16, 8) prove, and
# the ladders of the SRS bases' set-up
PROVE_NONDENSE_G1_LAUNCHES = {"g1_add_masked": 1755, "g1_scalar_mul": 3}
SRS_LADDERS = 6
# the most phase launches one (16, 8) prove may make: one a call and two
# head rounds for its 2^15 table, 9 (116 when the kernel took two launches
# a round)
PROVE_PHASE_LAUNCHES_MAX = 16
# the names the profiler gives the team kernels of g1.cu
ADD_KERNEL, ACCUMULATE_KERNEL = "add_team_kernel", "accumulate_team_kernel"
POINT_OP_KERNEL = "point_op_team_kernel"  # add_mixed and double
LADDER_KERNEL, MASKED_KERNEL = "scalar_mul_team_kernel", "masked_op_team_kernel"


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


def _device_ms(fn, tag: str, reps: int = 10, sessions: int = 3, launches_a_call: int = 0):
    """Mean device milliseconds of the kernels whose name holds ``tag``
    over ``reps`` runs of ``fn`` under ``torch.profiler`` (after one
    warm-up run), a launch (or, given ``launches_a_call``, a run of
    ``fn``, all its launches together): the kernel's own time where the
    host's time per call exceeds it, which events around the call would
    measure instead.  A session sometimes drops launches, so up to
    ``sessions`` are tried: for a launch's time, the first that reports
    any; for a run's, the first that reports every launch of the ``reps``
    runs (one that dropped some would read too fast).  None (not
    measured) when none qualifies."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in _device_events(prof) if tag in e.key]
        count = sum(e.count for e in events)
        if launches_a_call and count != reps * launches_a_call:
            print(f"device time of {tag}: a profile session held {count} of "
                  f"{reps * launches_a_call} launches", file=sys.stderr)
            continue
        if count:
            per = reps if launches_a_call else count
            return sum(_self_device_us(e) for e in events) / 1e3 / per
    return None


def _device_events(prof) -> list:
    """The profiler's averages of what ran on the card (kernels, copies,
    memsets) with device time.  A host-side op reports its kernels' time
    as its own too, and a ``timed`` span's range on the card spans the
    kernels inside it, so a sum over every event would count that time
    twice."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and _self_device_us(e) > 0]


def _self_device_us(event) -> float:
    """A profiler event's own device time, microseconds (the attribute's
    name before torch 2.4 was ``self_cuda_time_total``)."""
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


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
    if a.numel() == 0:
        return 0
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
def _misaligned(F, n: int) -> torch.Tensor:
    """n random elements of F, contiguous, based 4 bytes past a 16-byte
    boundary (read with 4-byte loads)."""
    flat = torch.zeros((n + 1) * F.L, dtype=torch.int32, device=F.device)
    off = next(k for k in range(4) if (flat.data_ptr() + 4 * k) % 16 == 4)
    x = flat[off:off + n * F.L].view(n, F.L)
    x.copy_(F.random((n,), 55))
    return x


def binary_cases(F, outer=(64, 256)) -> dict:
    """Operand pairs of the elementwise kernel, each read in place: the edge
    values 0, 1, p - 1, R mod p and (p - 1) / 2 paired every way, a
    transposed view, a stepped slice, a middle broadcast, an outer product
    ``[outer[0], 1] x [1, outer[1]]`` (pss2ss's), a trailing block, the
    prove's [10, 3, 1] x constant, a misaligned base beside a transposed
    column, and 300 contiguous pairs with a misaligned one (a staged
    launch's partial last tile, staged with 16-byte and with 4-byte loads)."""
    edge = F.array_from_ints([0, 1, F.p - 1, F.spec.r % F.p, (F.p - 1) // 2]).contiguous()
    rand = lambda shape, seed: F.random(shape, seed).contiguous()  # noqa: E731
    return {
        "edge": (edge.repeat_interleave(5, dim=0), edge.repeat(5, 1)),
        "transposed": (rand((5, 7), 41).transpose(0, 1), rand((7, 5), 42)),
        "stepped": (rand((20,), 43)[::3], rand((7,), 44)),
        "middle_broadcast": (rand((3, 1), 45), rand((1, 5), 46)),
        "outer_product": (rand((outer[0], 1), 47), rand((1, outer[1]), 48)),
        "trailing_block": (rand((4, 8), 49), rand((8,), 50)),
        "constant": (rand((10, 3, 1), 51), edge[2]),
        "misaligned": (_misaligned(F, 7), rand((1, 7), 52).transpose(0, 1)),
        "partial_tiles": (rand((300,), 53), _misaligned(F, 300)),
    }


def check_binary_cases(F, cases: dict) -> list:
    """``cases`` (``binary_cases``) through ``mul``, ``add`` and ``sub`` and
    through the C entry in small and in staged launches, bit for bit
    against the plain versions, none of their operands copied; returns the
    cases held."""
    lib = cuda_build.library("fr", cuda_fr._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    before = cuda_fr.copies
    for name, (x, y) in cases.items():
        for op in ("mul", "add", "sub"):
            ref = getattr(cuda_fr, f"{op}_plain")(F.spec, x, y)
            what = f"{F.spec.name} {op} {name} {tuple(x.shape)} x {tuple(y.shape)}"
            _equal(what, getattr(cuda_fr, op)(F.spec, x, y), ref)
            for staged in (False, True):
                _equal(f"{what} (staged {staged})",
                       cuda_fr.run_binary(lib, op, F.spec, x, y, stream, staged), ref)
    if cuda_fr.copies != before:
        raise AssertionError(f"{F.spec.name}: {cuda_fr.copies - before} operands copied")
    return list(cases)


def check_elementwise(F, m: int, int_rate: float) -> list[dict]:
    """Each op on m random pairs and the edge values against its plain
    version, timed (events, and device time from ``torch.profiler``, also
    of the same launch unstaged), beside its bound, with its kernel's
    registers and spill (small and staged launches); then large launches
    with a constant and a trailing block, and ``check_binary_cases``."""
    a = F.random((m,), 101)
    b = F.random((m,), 102)
    edge = F.array_from_ints([0, 1, F.p - 1, F.spec.r % F.p, (F.p - 1) // 2])
    a = torch.cat([a, edge.repeat_interleave(5, dim=0)])
    b = torch.cat([b, edge.repeat(5, 1)])
    lib = cuda_build.library("fr", cuda_fr._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
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
        device = _device_ms(lambda: kern(F.spec, a, b), "binary_kernel")
        small = _device_ms(lambda: cuda_fr.run_binary(lib, op, F.spec, a, b, stream, False),
                           "binary_kernel")
        staged = cuda_fr.attributes(F.spec, op, staged=True)
        rows.append({
            "op": op, "field": F.spec.name, "shape": [n, F.L], "max_abs_err": err,
            "ms": _ms(lambda: kern(F.spec, a, b)),
            "device_ms": "not measured" if device is None else device,
            "unstaged_device_ms": "not measured" if small is None else small,
            "plain_ms": _ms(lambda: plain(F.spec, a, b)),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            **cuda_fr.attributes(F.spec, op), "staged_registers": staged["registers"],
            "staged_spill_bytes": staged["spill_bytes"],
        })
    # large launches (staged) with operands that are not dense: a constant,
    # a repeated trailing block of 1,024
    blk = 1024
    for x, y in ((a, b[0]), (a[: m // blk * blk].reshape(-1, blk, F.L), b[:blk])):
        for op in ("mul", "add", "sub"):
            _equal(f"{F.spec.name} {op} {tuple(x.shape)} x {tuple(y.shape)}",
                   getattr(cuda_fr, op)(F.spec, x, y),
                   getattr(cuda_fr, f"{op}_plain")(F.spec, x, y))
    rows[0]["cases_held"] = check_binary_cases(F, binary_cases(F))
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


# the tables the (16, 8) prove folds ([B, M]: the gate identity and its
# phase 2, wire 2.c (2^15: two head rounds) and its phase 2, the zerocheck
# z3 and its leader fold, the tree top), [1, 2^13] and [3, 2^10], M = 2 and
# 4, a cluster of each size (K = 1, 2, 4, 8 at M = 128 .. 1024) and the
# envelope's [1, 2^21] (eight head rounds)
PHASE_CHECKS = ((6, 1 << 13), (6, 8), (1, 1 << 15), (1, 8), (3, 1 << 12), (3, 64),
                (1, 1 << 13), (3, 1 << 10), (2, 2), (2, 4), (2, 128), (2, 256), (2, 512),
                (2, 1024), (1, 1 << 21))
# the phase's shapes timed against the parent's figures (PERF.md)
PHASE_TIMED = ((6, 1 << 13), (1, 1 << 21), (1, 1 << 25))
PHASE_KERNELS = "phase_"  # phase_cluster_kernel and phase_head_kernel


def check_phase(F, cases=PHASE_CHECKS) -> tuple[int, list]:
    """The phase kernel against its plain version, every output limb, at
    each [B, M] of ``cases`` on random tables with 0, 1 and p - 1 in the
    first slot and among the challenges, with the launches its plan (K,
    head rounds) makes; returns (largest difference, [B, M, K, head] of
    each case) or raises."""
    edge = F.array_from_ints([0, 1, F.p - 1])
    held = []
    for B, M in cases:
        f, g, ch = _phase_inputs(F, B, M)
        n = min(M, 3)
        f[0, :n], g[0, -n:], ch[2:5] = edge[:n], edge[-n:], edge
        before = cuda_sumcheck.product_phase.launches
        km, kf, kg = cuda_sumcheck.product_phase(F, f, g, ch, 2)
        launches = cuda_sumcheck.product_phase.launches - before
        pm, pf, pg = cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, 2)
        torch.cuda.synchronize()
        K, head = cuda_sumcheck.plan(M)
        _equal(f"phase B={B} M={M} K={K} head={head}", km + [kf, kg], pm + [pf, pg])
        if launches != head + 1:
            raise AssertionError(f"phase B={B} M={M}: {launches} launches, want {head + 1}")
        held.append([B, M, K, head])
    return 0, held


def phase_bound(F, B: int, M: int, int_rate: float, imad_ns: float) -> dict:
    """The phase's least time: the larger of its bytes (both tables read
    once, messages and finals written once) over HBM rate, its products
    (5 a pair and round, B (M - 1) pairs) over the integer rate, and its
    chain: R rounds of one product's dependent multiply-adds
    (``cios_depth(8)``) at one IMAD.WIDE's measured latency."""
    R = M.bit_length() - 1
    out_bytes = B * (R * 3 + 2) * F.L * 4
    t_bytes = (2 * B * M * F.L * 4 + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = B * (M - 1) * 5 * _mont_muls(F.spec.num_words) / int_rate * 1e3
    t_chain = R * cios_depth(F.spec.num_words) * imad_ns * 1e-6
    bound = max(t_bytes, t_ops, t_chain)
    by = "bytes" if bound == t_bytes else "operations"
    return {"bound_ms": bound, "bound_by": by,
            "bound_kind": "dependent-product chain" if bound == t_chain else "throughput",
            "bytes_ms": t_bytes, "operations_ms": t_ops, "chain_ms": t_chain}


def time_phase(F, B: int, M: int, int_rate: float, imad_ns: float, plain: bool = True) -> dict:
    """Events around one wrapper call and the device time of all its
    launches (``torch.profiler``), beside the bound; the plain version's
    events time where ``plain``."""
    f, g, ch = _phase_inputs(F, B, M)
    run = lambda: cuda_sumcheck.product_phase(F, f, g, ch, 0)  # noqa: E731
    K, head = cuda_sumcheck.plan(M)
    device = _device_ms(run, PHASE_KERNELS, launches_a_call=head + 1)
    row = {"shape": [B, M, F.L], "ms": _ms(run),
           "device_ms": "not measured" if device is None else device,
           "cluster": K, "head_rounds": head, "launches_a_call": head + 1,
           "smem_bytes": cuda_sumcheck.smem_bytes(M >> head, K),
           **phase_bound(F, B, M, int_rate, imad_ns), "library_ms": None}
    if plain:
        row["plain_ms"] = _ms(lambda: cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, 0))
    return row


def fr_chain(F) -> dict:
    """The carry-chain Fr product the phase folds with against fmul<8>
    (``cuda_fr.mul``) on 2^16 random pairs and every pair of 0, 1, r - 1,
    R mod r, bit for bit; both products' time in a one-thread chain of
    dependent products (checked against host integers)."""
    edge = F.array_from_ints([0, 1, F.p - 1, F.spec.r % F.p])
    a = torch.cat([F.random((1 << 16,), 81), edge.repeat_interleave(4, dim=0)])
    b = torch.cat([F.random((1 << 16,), 82), edge.repeat(4, 1)])
    _equal("fr_mul_cc against fmul<8>", cuda_sumcheck.fr_mul_cc(F.spec, a, b),
           cuda_fr.mul(F.spec, a, b))
    xy = F.random((2,), 83)
    x, y = (int(v) for v in F.array_to_ints(xy))
    out = {"fr_mul_cc_held_on": a.shape[0]}
    for cc, name in ((False, "fr_product_fmul_chain_us"), (True, "fr_product_cc_chain_us")):
        probe = lambda k, cc=cc: cuda_sumcheck.fr_mul_chain(F.spec, xy, k, cc)  # noqa: E731
        if int(F.array_to_ints(probe(5))) != x * pow(y, 5, F.p) % F.p:
            raise AssertionError(f"fr_mul_chain (cc={cc}): wrong product")
        out[name] = _chain_step_ms(probe, 1 << 16) * 1e3
    return out


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
    implementation reaches, not a bound, and what the low-latency product
    of csrc/fq_chain.cuh (Horner's and bucket-serial's) takes.  Every
    chain's result is checked against host integers."""
    Fq = curve.fq
    c, y = 0x9E3779B9, 0x7F4A7C15
    xy = torch.from_numpy(np.array([c, y], dtype=np.uint32).view(np.int32)).to(curve.device)
    for _ in range(5):
        c = ((c & 0xFFFFFFFF) * y + c) & 0xFFFFFFFFFFFFFFFF
    if int(cuda_g1.imad_chain(xy, 5).item()) & 0xFFFFFFFFFFFFFFFF != c:
        raise AssertionError("imad_chain: wrong result")
    step_ms = _chain_step_ms(lambda k: cuda_g1.imad_chain(xy, k), 1 << 20)
    fxy = Fq.random((2,), 71)
    x, y = (int(v) for v in Fq.array_to_ints(fxy))
    for probe in (cuda_g1.fq_mul_chain, cuda_g1.fq_mul_cc_chain):
        if int(Fq.array_to_ints(probe(Fq.spec, fxy, 5))) != x * pow(y, 5, Fq.p) % Fq.p:
            raise AssertionError(f"{probe.__name__}: wrong product")
    depth = cios_depth(Fq.spec.num_words)
    diag = {"imad_wide_latency_ns": step_ms * 1e6, "cios_depth": depth,
            "fq_product_chain_bound_us": depth * step_ms * 1e3,
            "fq_product_fmul_chain_us": _chain_step_ms(
                lambda k: cuda_g1.fq_mul_chain(Fq.spec, fxy, k), 1 << 16) * 1e3,
            "fq_product_cc_chain_us": _chain_step_ms(
                lambda k: cuda_g1.fq_mul_cc_chain(Fq.spec, fxy, k), 1 << 16) * 1e3}
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
    rows["g1_add"]["device_ms"] = _device_ms(lambda: cuda_g1.add(spec, p1, p2), ADD_KERNEL)
    rows["g1_add_mixed"]["device_ms"] = _device_ms(lambda: cuda_g1.add_mixed(spec, p1, a2),
                                                   POINT_OP_KERNEL)
    err = _equal("g1 double", cuda_g1.double(spec, p1), cuda_g1.double.plain(spec, p1))
    rows["g1_double"] = _g1_row("double", (M, spec.num_limbs), err,
                                _ms(lambda: cuda_g1.double(spec, p1)),
                                _ms(lambda: cuda_g1.double.plain(spec, p1), reps=3),
                                _g1_bound(M * 7, 6 * M * 96, DOUBLE_DEPTH, int_rate, lat_ms))
    rows["g1_double"]["device_ms"] = _device_ms(lambda: cuda_g1.double(spec, p1), POINT_OP_KERNEL)

    # scalar ladder: 1,024 random full-width scalars and 0, 1, r - 1, then
    # the diverging warp and the 2-limb scalars of ladder_cases
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
    run = lambda: cuda_g1.scalar_mul(spec, pts, sc)  # noqa: E731
    rows["g1_scalar_mul"] = _g1_row("scalar_mul", tuple(sc.shape), err, _ms(run), plain_ms,
                                    _ladder_bound(sc, int_rate, lat_ms))
    rows["g1_scalar_mul"]["device_ms"] = _device_ms(run, LADDER_KERNEL)
    held = []
    for name, args in ladder_cases(curve):
        _equal(f"g1 scalar_mul ({name})", cuda_g1.scalar_mul(spec, *args),
               cuda_g1.scalar_mul.plain(spec, *args))
        held.append(name)

    # the accumulate on a forced x-collision, a warp whose teams diverge and
    # random keys over two staging chunks (each case doubles somewhere)
    repaired = {}
    for name, args in accumulate_cases(curve):
        out = cuda_g1.accumulate(spec, *args)
        _equal(f"g1 accumulate ({name})", out, cuda_g1.accumulate.plain(spec, *args))
        if out[1] <= 0:
            raise AssertionError(f"accumulate ({name}): no lane repaired")
        repaired[name] = out[1]
    masked_rows, masked_held = check_masked(curve, int_rate, lat_ms)
    rows.update(masked_rows)
    return rows, {"accumulate_repaired": repaired, "ladder_cases_held": held,
                  "masked_cases_held": masked_held}


def _ladder_bound(sc: torch.Tensor, int_rate: float, lat_ms: float):
    """The ladder's bound on standard-form scalar limbs ``sc`` [m, L]: per
    lane the point and the scalar read and the point written; the products
    and the longest lane's chain of dependent products of the cheaper of
    two schedules for these scalars: double-and-add (a double of 7
    products at every bit, a general add of 16 at every set bit but a
    lane's first, which meets infinity) and the kernel's 4-bit windows (a
    double at every bit, a table of one double and 13 adds, an add at every
    non-zero window but a lane's first)."""
    lanes, L = sc.shape
    nbits = 16 * L
    sc = sc.to(torch.int64)
    ones = sum(((sc >> b) & 1).sum(-1) for b in range(16))
    windows = sum((((sc >> b) & 15) != 0).sum(-1) for b in range(0, 16, 4))
    table = 13 * 16 + 7
    serial = (lanes * nbits * 7 + int((ones - 1).clamp(min=0).sum()) * 16,
              nbits * DOUBLE_DEPTH + int((ones - 1).clamp(min=0).max()) * ADD_DEPTH)
    windowed = (lanes * (nbits * 7 + table) + int((windows - 1).clamp(min=0).sum()) * 16,
                nbits * DOUBLE_DEPTH + DOUBLE_DEPTH
                + (13 + int((windows - 1).clamp(min=0).max())) * ADD_DEPTH)
    return _g1_bound(min(serial[0], windowed[0]), lanes * (2 * 288 + 4 * L),
                     min(serial[1], windowed[1]), int_rate, lat_ms)


def accumulate_cases(curve) -> list:
    """(name, (keys, pid, neg, bases, T, steps)) for the accumulate, each
    with at least one doubling:

    * ``collision``: 4 lanes of 3 steps, buckets 0 and 3 hold a point twice;
    * ``diverging_warp``: 8 lanes, whose teams share one warp, of 6 steps,
      where the teams take different branches at the same step: at step 1
      three add, two double, two cancel and one resets; lane 6 adds to the
      infinity a cancel left; lane 7 runs into padding at step 2; 4
      doublings in all;
    * ``random_two_chunks``: 72 lanes (a full block of 64 lanes and a
      partial one) of 70 steps (past one 64-step staging chunk), keys
      sorted from 300 buckets, bases and signs at random, the last 13
      entries padding."""
    dev = curve.device
    P = curve.double(rand_points_flat(curve, 16, 61))
    bases = map_points(lambda a: a.contiguous(), curve.normalize(P))
    t = lambda v, dt=torch.int64: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    cases = [("collision", (t([0, 0, 0, 1, 1, 2, 3, 3, 3, 3]), t([0, 0, 1, 2, 3, 4, 5, 5, 6, 7]),
                            t([0, 0, 1, 0, 1, 0, 0, 0, 0, 1], torch.bool), bases, 4, 3))]
    lanes = [  # (keys, pid, neg) of each lane's 6 steps
        ([0, 0, 0, 0, 1, 1], [0, 1, 2, 3, 4, 5], [0, 1, 0, 0, 0, 1]),  # adds, a reset
        ([1, 1, 2, 2, 2, 3], [6, 6, 6, 7, 0, 1], [0, 0, 0, 0, 0, 0]),  # doubles at step 1
        ([3, 3, 4, 4, 5, 5], [2, 2, 3, 3, 4, 5], [0, 1, 0, 0, 0, 0]),  # cancel, then doubles
        ([6, 7, 8, 9, 10, 11], [8, 9, 10, 11, 12, 13], [0, 1, 0, 1, 0, 1]),  # resets only
        ([12] * 6, [0, 1, 2, 3, 4, 5], [1, 0, 1, 0, 1, 0]),  # adds only
        ([13, 13, 13, 14, 14, 14], [7, 7, 7, 14, 15, 14], [0, 0, 0, 0, 1, 0]),  # double, add
        ([15, 15, 16, 16, 16, 16], [1, 1, 5, 5, 5, 5], [0, 1, 0, 1, 0, 0]),  # cancels, double
        ([17, 17], [3, 4], [0, 0]),  # then padding
    ]
    cases.append(("diverging_warp", (t(sum((k for k, _, _ in lanes), [])),
                                     t(sum((p for _, p, _ in lanes), [])),
                                     t(sum((n for _, _, n in lanes), []), torch.bool),
                                     bases, 8, 6)))
    rng = np.random.RandomState(62)
    T, steps = 72, 70
    E = T * steps - 13
    cases.append(("random_two_chunks", (t(np.sort(rng.randint(0, 300, E))),
                                        t(rng.randint(0, 16, E)),
                                        t(rng.randint(0, 2, E), torch.bool), bases, T, steps)))
    return cases


def ladder_cases(curve) -> list:
    """(name, (points, scalars)) for the ladder, scalars standard-form
    16-bit limbs, on random points (Z != 1):

    * ``diverging_warp``: 8 lanes, one warp of 4-lane teams, on full-width
      scalars whose bits set apart the warp's teams at every step: 0, 1,
      r - 1, r (its last add cancels to infinity), r + 2 (its last add
      meets its own point and doubles), 0xAAAA.., 0x5555.. and a random
      scalar on the point at infinity;
    * ``short_scalars``: 12 lanes, a full and a partial block, of 2-limb
      scalars, as the SRS set-up's ladders take them: 0, 1, 2^32 - 1,
      2^31 + 1 and random ones."""
    Fr = curve.fr
    P = curve.double(rand_points_flat(curve, 20, 76))
    rng = np.random.RandomState(77)
    full = [0, 1, Fr.p - 1, Fr.p, Fr.p + 2, (1 << 256) // 3 * 2, (1 << 256) // 3,
            int(rng.randint(1, 1 << 62)) << 190]
    short = [0, 1, (1 << 32) - 1, (1 << 31) + 1] + [int(v) for v in rng.randint(1, 1 << 31, 8)]
    limbs = lambda vs, n: torch.from_numpy(  # noqa: E731
        np.stack([int_to_limbs(v, n) for v in vs]).astype(np.int32)).to(curve.device)
    inf = curve.infinity((1,))
    pts = map_points(lambda a, b: torch.cat([a[:7], b]), P, inf)
    return [("diverging_warp", (pts, limbs(full, Fr.L))),
            ("short_scalars", (map_points(lambda a: a[8:], P), limbs(short, 2)))]


def masked_cases(curve, m: int) -> list:
    """(name, (p1, affine p2, mask)) for the masked adds over m random
    points (Z != 1) and the six edge lanes of ``_edge_points`` (two
    x-collisions that double, a cancel, three with infinity): a random 0/1
    mask, 1 on the edge lanes, and masks of all 0s, all 1s and 0, 1
    alternating (which masks off half the edge lanes)."""
    P = curve.double(rand_points_flat(curve, m, 64))
    Q = curve.double(rand_points_flat(curve, m, 65))
    p1, p2 = _edge_points(curve, P, Q)
    a2 = curve.normalize(p2)
    M = p1.x.shape[0]
    mask = np.random.RandomState(66).randint(0, 2, size=M).astype(bool)
    mask[m:] = True
    ones = torch.ones(M, dtype=torch.bool, device=curve.device)
    alternating = torch.arange(M, device=curve.device) % 2 == 1
    return [("random", (p1, a2, torch.from_numpy(mask).to(curve.device))),
            ("zeros", (p1, a2, ~ones)), ("ones", (p1, a2, ones)),
            ("alternating", (p1, a2, alternating))]


def check_masked(curve, int_rate: float, lat_ms: float):
    """add_masked and add_reset on 2^16 random points plus the edge lanes
    against their plain versions under each mask of ``masked_cases``, and
    timed under its random one; the bound counts 11 products per masked
    random lane (4 + 7 on a doubling lane, 4 on the cancel), and per lane
    the mask byte, the operand it copies or adds to and its output, with
    the second operand only where the mask is set.  Returns (rows keyed by
    kernel name, the cases held)."""
    spec = curve.fq.spec
    m = 1 << 16
    cases = masked_cases(curve, m)
    p1, a2, mask = cases[0][1]
    M = p1.x.shape[0]
    products = 11 * int(mask[:m].sum()) + 2 * (4 + 7) + 4
    nbytes = M * (1 + 2 * 288) + int(mask.sum()) * 288
    rows, held = {}, []
    for op in ("add_masked", "add_reset"):
        kern = getattr(cuda_g1, op)
        errs = [_equal(f"g1 {op} ({name})", kern(spec, *args), kern.plain(spec, *args))
                for name, args in cases]
        held += [f"{op} {name}" for name, _ in cases]
        bound = _g1_bound(products, nbytes, ADD_DEPTH + DOUBLE_DEPTH, int_rate, lat_ms)
        run = lambda: kern(spec, p1, a2, mask)  # noqa: E731
        rows[f"g1_{op}"] = _g1_row(op, (M, spec.num_limbs), max(errs), _ms(run),
                                   _ms(lambda: kern.plain(spec, p1, a2, mask), reps=3), bound)
        rows[f"g1_{op}"]["device_ms"] = _device_ms(run, MASKED_KERNEL)
    return rows, held


def chain_grid(curve):
    """[8, 5] window totals / buckets over random points (Z != 1), row 0
    least significant: column 0 random; column 1 makes Horner at c = 4
    double and then cancel (rows 7, 6, 5 = Q, 16Q, -512Q); column 2 makes
    bucket-serial double and then cancel (rows 7, 6, 5 = P, P, -2P);
    column 3 holds infinity in rows 1, 3 and 4; column 4 is all infinity."""
    P = curve.double(rand_points_flat(curve, 40, 67))
    row = lambda i: map_points(lambda a: a[i:i + 1], P)  # noqa: E731
    q = row(8)
    special = {(7, 1): q, (6, 1): curve.scalar_mul_int(q, [16]),
               (5, 1): curve.neg(curve.scalar_mul_int(q, [512])),
               (7, 2): row(9), (6, 2): row(9), (5, 2): curve.neg(curve.double(row(9))),
               (1, 3): curve.infinity((1,)), (3, 3): curve.infinity((1,)),
               (4, 3): curve.infinity((1,))}
    cells = [special.get((k, m), curve.infinity((1,)) if m == 4 else row(5 * k + m))
             for k in range(8) for m in range(5)]
    return map_points(lambda *a: torch.cat(a).reshape(8, 5, -1), *cells)


def check_chain(curve) -> dict:
    """csrc/g1_chain.cu against the plain versions: ``fq_mul_cc`` against
    Fq ``mul`` (``fmul``) on 2^16 random pairs and the edge values 0, 1,
    p - 1, R mod p, (p - 1) / 2; Horner on ``chain_grid`` at c = 1 and 4;
    bucket-serial on it with S = 1, 2, 3 (K - 1 not a multiple of S), 4
    and 7 segments, at K = 2, and with S from ``bucket_segments``.  Raises
    on any difference; returns the cases held."""
    spec, Fq = curve.fq.spec, curve.fq
    a, b = Fq.random((1 << 16,), 68), Fq.random((1 << 16,), 69)
    edge = Fq.array_from_ints([0, 1, Fq.p - 1, Fq.spec.r % Fq.p, (Fq.p - 1) // 2])
    a, b = torch.cat([a, edge.repeat_interleave(5, dim=0)]), torch.cat([b, edge.repeat(5, 1)])
    _equal("fq_mul_cc", cuda_g1.fq_mul_cc(spec, a, b), cuda_fr.mul(spec, a, b))
    grid = chain_grid(curve)
    cases = ["fq_mul_cc"]
    for c in (1, 4):
        _equal(f"g1 horner c={c}", cuda_g1.horner(spec, grid, c),
               cuda_g1.horner.plain(spec, grid, c))
        cases.append(f"horner c={c}")
    k2 = map_points(lambda a: a[:2], grid)
    for bk, S in ((grid, 1), (grid, 2), (grid, 3), (grid, 4), (grid, 7), (grid, None), (k2, None)):
        K = bk.x.shape[0]
        _equal(f"g1 bucket_serial K={K} S={S}", cuda_g1.bucket_serial(spec, bk, S),
               cuda_g1.bucket_serial.plain(spec, bk, S))
        cases.append(f"bucket_serial K={K} S={S}")
    return {"chain_kernels_held": cases}


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
            shape = (K, Mb, cuda_g1.bucket_segments(K, Mb))
        t0 = time.perf_counter()
        kern.plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rows[key] = _g1_row(name, shape, errs[key], _ms(lambda: kern(*args)), plain_ms, bound)
        if name == "accumulate":  # the wrapper also waits for the repair count
            rows[key]["device_ms"] = _device_ms(lambda: kern(*args), ACCUMULATE_KERNEL)
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


def _snapshot(x):
    """``x`` as it is now: tensors cloned, lists and tuples copied (a caller
    may append to the list of messages a phase returns, as
    ``sumcheck_product`` does, or write into a tensor later)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_snapshot(a) for a in x)
    return x


def _keep_snapshot(calls: list, entry):
    calls.append(_snapshot(entry))


@contextlib.contextmanager
def phase_recording():
    """Keep every call of the phase kernel's wrapper inside the block, its
    operands and results as they were at the call."""
    calls = []
    sumcheck_module.cuda_sumcheck = _Recorder(cuda_sumcheck, "sumcheck_", ("product_phase",), calls,
                                              keep=_keep_snapshot)
    try:
        yield calls
    finally:
        sumcheck_module.cuda_sumcheck = cuda_sumcheck


@contextlib.contextmanager
def recording():
    """Keep every field-, phase- and G1-kernel call the port makes inside
    the block (the ``Field`` ops, the sumcheck rounds, the ``Curve`` ops
    and the MSM reach the kernels only through these module references)."""
    calls = []
    fr_module.cuda_fr = _Recorder(cuda_fr, "fr_", ("mul", "add", "sub"), calls)
    sumcheck_module.cuda_sumcheck = _Recorder(cuda_sumcheck, "sumcheck_", ("product_phase",), calls,
                                              keep=_keep_snapshot)
    g1_module.cuda_g1 = msm_module.cuda_g1 = _Recorder(cuda_g1, "g1_", G1_WRAPPERS, calls)
    try:
        yield calls
    finally:
        fr_module.cuda_fr, sumcheck_module.cuda_sumcheck = cuda_fr, cuda_sumcheck
        g1_module.cuda_g1 = msm_module.cuda_g1 = cuda_g1


# Horner's plain version walks ~256 doubles and W adds one after the
# other; on at most this many window totals its small tensor ops run
# 2-3x faster on host copies of the operands than as launches on the card
# (the same int64 arithmetic, so the same bits).  On an H100 machine's
# host, bucket-serial and the ladder, and Horner on the sim prove's wider
# grids, replayed slower than on the card, so they stay there.
HOST_REPLAY_POINTS = 4096


def _on_host(x):
    """``x`` with every tensor copied to the host (nested tuples and lists kept)."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, PointJ):
        return PointJ(*(_on_host(a) for a in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_on_host(a) for a in x)
    return x


def replay(calls) -> tuple[dict, dict]:
    """Each recorded call's result against the plain version on the same
    operands (Horner's on host copies up to ``HOST_REPLAY_POINTS`` window
    totals).  Returns ({kernel:
    calls replayed}, {kernel: largest difference found}); raises on any
    difference."""
    seen, errs = {}, {}
    for key, args, out in calls:
        if key.startswith("g1_"):
            if key == "g1_horner" and args[1][0].shape[:-1].numel() <= HOST_REPLAY_POINTS:
                args, out = _on_host(args), _on_host(out)
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
    cuda_fr.copies = 0


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


# the engine configurations other than the default, each a fresh block
ENGINE_CONFIGS = {"nondense": lambda: msm_config(False), "mxu": mxu_config}


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


def prove_phase(launches: dict, replayed: dict, int_rate: float, lat_ms: float,
                imad_ns: float) -> dict:
    """The main path: ``dhyperplonk`` at n = 16, l = 8, leader mode, through
    the bench entry (setup, warm-up, three synchronised proves, one with
    synchronised spans), its digest and comm against the pins, then one
    prove counted on its own in each MSM configuration.  The non-dense
    prove's first and last ``add_masked`` step of every loop is replayed
    through the plain version.  Then the ``SCZK_MXU=1`` proves, one prove
    in each MSM configuration whose G1 call shapes are kept
    (``prove_shapes``, ``nondense_shapes``) and one in each under
    ``torch.profiler``."""
    n, l = PROVE["n"], PROVE["l"]
    report, (pk, net, _) = bench_module.run(n, l, "cuda", repeat=3)
    _check_pin(f"prove_n{n}_l{l}", int(report["digest"], 16))
    for dense in (True, False):
        key = "prove" if dense else "prove_nondense"
        with msm_config(dense), (phase_recording() if dense else sampling_masked()) as kept:
            net.reset_comm()
            _reset_counts()
            t0 = time.perf_counter()
            out = dhyperplonk(n, pk, net)
            torch.cuda.synchronize()
            report[f"{key}_s"] = time.perf_counter() - t0
            launches[key] = _counts()
            report[f"{key}_fr_copies"] = cuda_fr.copies
        _check_pin(f"prove_n{n}_l{l}_comm", _comm(net))
        _check_pin(f"prove_n{n}_l{l}", proof_digest(pk.curve, out))
        report[f"{key}_launches"] = {k: v for k, v in launches[key].items() if v}
        del out
        if dense:  # every phase call of the prove, held against the plain version
            replayed["prove"] = replay(kept)[0]
            phase_calls = replayed["prove"]["sumcheck_product_phase"]
            phase_launches = launches["prove"]["sumcheck_product_phase"]
            planned = sum(cuda_sumcheck.plan(args[1].shape[-2])[1] + 1 for _, args, _ in kept)
            if phase_launches != planned or phase_launches > PROVE_PHASE_LAUNCHES_MAX:
                raise AssertionError(f"the prove made {phase_calls} phase calls in "
                                     f"{phase_launches} launches (planned {planned}, at most "
                                     f"{PROVE_PHASE_LAUNCHES_MAX})")
            report["phase_shapes"] = sorted(collections.Counter(
                tuple(args[1].shape[:-1]) for _, args, _ in kept).items())
            report["phase_calls_replayed"] = phase_calls
    replayed["prove_nondense"], errs = replay(kept)
    report["add_masked_steps_replayed"] = len(kept)
    report["add_masked_replay_max_abs_err"] = errs["g1_add_masked"]
    report["comm_pinned"] = list(PINS[f"prove_n{n}_l{l}_comm"])
    del kept
    report.update(mxu_prove(pk, net, n, launches))
    report["shapes"] = prove_shapes(pk, net, n, int_rate, lat_ms)
    report["shapes_nondense"] = nondense_shapes(pk, net, n, int_rate, lat_ms)
    report.update(elementwise_shapes(pk, net, n, int_rate, imad_ns))
    report["profile"] = profile_prove(pk, net, n)
    report["profile_nondense"] = profile_prove(pk, net, n, dense=False)
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


def _call_shape(name: str, args):
    """What sizes one call: lanes of a point add, (W, C, c) of Horner,
    (K, M, S) of bucket-serial, (lanes, scalar limbs) of the ladder,
    (lanes, masked lanes) of ``add_masked``."""
    if name == "g1_add":
        return torch.broadcast_shapes(args[1][0].shape, args[2][0].shape)[:-1].numel()
    if name == "g1_horner":
        return tuple(args[1][0].shape[:2]) + (args[2],)
    if name == "g1_scalar_mul":
        pt, sc = args[1], args[2]
        return (torch.broadcast_shapes(pt[0].shape[:-1], sc.shape[:-1]).numel(), sc.shape[-1])
    if name == "g1_add_masked":
        mask = args[3]
        return (torch.broadcast_shapes(args[1][0].shape[:-1], mask.shape).numel(),
                int(mask.sum()))
    K, M = args[1][0].shape[:2]
    return (K, M, cuda_g1.bucket_segments(K, M))


def check_add_lanes(curve, lanes) -> list:
    """Point ``add`` against its plain version at each lane count of
    ``lanes`` on random points (Z != 1), and with the six edge lanes of
    ``_edge_points`` at 3 lanes (two calls) and at 8,192 (the last six of
    8,192), one launch a call (making the random points launches more);
    returns the cases held."""
    spec = curve.fq.spec
    cases = []

    def held(name, a, b):
        before = cuda_g1.add.launches
        got = cuda_g1.add(spec, a, b)
        if cuda_g1.add.launches != before + 1:
            raise AssertionError(f"{name}: {cuda_g1.add.launches - before} launches, want 1")
        _equal(name, got, cuda_g1.add.plain(spec, a, b))

    for m in sorted(set(lanes)):
        p1 = curve.double(rand_points_flat(curve, m, 72))
        p2 = curve.double(rand_points_flat(curve, m, 73))
        held(f"g1 add at {m} lanes", p1, p2)
        cases.append(m)
    P = curve.double(rand_points_flat(curve, 8186, 74))
    Q = curve.double(rand_points_flat(curve, 8186, 75))
    p1, p2 = _edge_points(curve, P, Q)
    for lo, hi in ((8186, 8189), (8189, 8192), (0, 8192)):
        a, b = (map_points(lambda x: x[lo:hi], pt) for pt in (p1, p2))
        held(f"g1 add at {hi - lo} lanes with edge lanes", a, b)
        cases.append(f"{hi - lo} with edge lanes")
    return cases


def _kept_shapes(pk, net, n: int, names, dense: bool = True) -> list:
    """One prove in the MSM configuration ``dense`` with the shape of every
    call to the G1 wrappers ``names`` kept (the calls themselves are not),
    as (kernel name, ``_call_shape``)."""
    calls = []

    def keep(kept, entry):
        kept.append((entry[0], _call_shape(entry[0], entry[1])))
    g1_module.cuda_g1 = msm_module.cuda_g1 = _Recorder(cuda_g1, "g1_", names, calls, keep=keep)
    try:
        with msm_config(dense):
            dhyperplonk(n, pk, net)
            torch.cuda.synchronize()
    finally:
        g1_module.cuda_g1 = msm_module.cuda_g1 = cuda_g1
    return calls


def _timed_row(run, tag: str, bound) -> dict:
    """A kernel's device time a call (or "not measured" where the profiler
    saw no launch) and the time between CUDA events around one wrapper
    call, which at a few lanes is the host's time for the call, beside its
    bound."""
    device = _device_ms(run, tag)
    return {"device_ms": "not measured" if device is None else device, "event_ms": _ms(run),
            "bound_ms": bound[0], "bound_by": bound[1], "bound_kind": bound[2]}


def prove_shapes(pk, net, n: int, int_rate: float, lat_ms: float) -> dict:
    """One dense prove with the shape of every point ``add``, Horner,
    bucket-serial and ladder call kept, as histograms; then ``add`` held
    against its plain version at every lane count it saw
    (``check_add_lanes``) and timed on random points (Z != 1) at its four
    most frequent lane counts, and the ladder held and timed at every shape
    it saw, on random points (Z != 1) and random scalars, each beside its
    bound there (``_timed_row``)."""
    calls = _kept_shapes(pk, net, n, ("add", "horner", "bucket_serial", "scalar_mul"))
    hist = {k: collections.Counter(s for name, s in calls if name == k)
            for k in ("g1_add", "g1_horner", "g1_bucket_serial", "g1_scalar_mul")}
    curve, spec = pk.curve, pk.curve.fq.spec
    held = check_add_lanes(curve, hist["g1_add"])
    add_rows = []
    for m, count in hist["g1_add"].most_common(4):
        p1 = curve.double(rand_points_flat(curve, m, 72))
        p2 = curve.double(rand_points_flat(curve, m, 73))
        bound = _g1_bound(m * 16, 9 * m * 96, ADD_DEPTH, int_rate, lat_ms)
        add_rows.append({"lanes": m, "launches": count,
                         **_timed_row(lambda: cuda_g1.add(spec, p1, p2), ADD_KERNEL, bound)})
    ladder_rows = []
    for (m, L), count in sorted(hist["g1_scalar_mul"].items()):
        pts = curve.double(rand_points_flat(curve, m, 78))
        sc = ladder_scalars(curve, m, L, 79)
        _equal(f"g1 scalar_mul at {m} lanes x {L} limbs", cuda_g1.scalar_mul(spec, pts, sc),
               cuda_g1.scalar_mul.plain(spec, pts, sc))
        ladder_rows.append({"lanes": m, "limbs": L, "launches": count, **_timed_row(
            lambda: cuda_g1.scalar_mul(spec, pts, sc), LADDER_KERNEL,
            _ladder_bound(sc, int_rate, lat_ms))})
    return {"add_lanes_histogram": sorted(hist["g1_add"].items()),
            "add_held_at_lanes": held, "add_at_frequent_lanes": add_rows,
            "horner_shapes": sorted(hist["g1_horner"].items()),
            "bucket_serial_shapes": sorted(hist["g1_bucket_serial"].items()),
            "ladder_shapes": sorted(hist["g1_scalar_mul"].items()),
            "ladder_at_prove_shapes": ladder_rows}


def _view_snapshot(x):
    """A tensor operand as it is now and as it is laid out: a copy of the
    storage span it reads, viewed with its own sizes and strides, based at
    its own offset from a 16-byte boundary (a broadcast or a stepped view
    stays one, and takes the same instance of the kernel); anything else as
    it is."""
    if not isinstance(x, torch.Tensor) or x.numel() == 0:
        return _snapshot(x)
    span = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    off = x.data_ptr() % 16 // x.element_size()
    buf = torch.empty(span + off, dtype=x.dtype, device=x.device)  # 16-byte aligned
    buf[off:].copy_(x.as_strided((span,), (1,)))
    return buf[off:].as_strided(x.shape, x.stride())


def _keep_views(calls: list, entry):
    name, args, out = entry
    calls.append((name, tuple(_view_snapshot(a) for a in args), out.clone()))


def record_elementwise(run) -> tuple[list, list, dict]:
    """``run()`` with every Fr and Fq ``mul``, ``add`` and ``sub`` call kept,
    its operands as they were at the call and as they were laid out
    (``_view_snapshot``), and its result; every call replayed bit for bit
    against the plain version on its own operands.  Returns the calls, each
    call's (field, op, a's and b's batch shape), and a summary: the calls
    replayed, and the calls counted by the instance of the kernel they take
    (``cuda_fr.launch_mode``) and by outputs (log2, rounded up)."""
    calls = []
    fr_module.cuda_fr = _Recorder(cuda_fr, "fr_", ("mul", "add", "sub"), calls, keep=_keep_views)
    try:
        run()
    finally:
        fr_module.cuda_fr = cuda_fr
    keys = [(args[0].name, name[3:], tuple(args[1].shape[:-1]), tuple(args[2].shape[:-1]))
            for name, args, _ in calls]
    modes = collections.Counter((f"{k[0]} {k[1]}", cuda_fr.launch_mode(*args[1:]))
                                for k, (_, args, _) in zip(keys, calls))
    sizes = collections.Counter(math.ceil(math.log2(max(out.shape[:-1].numel(), 1)))
                                for _, _, out in calls)
    return calls, keys, {"elementwise_calls_replayed": replay(calls)[0],
                         "elementwise_calls_by_mode": sorted(modes.items()),
                         "elementwise_calls_by_log2_outputs": sorted(sizes.items()),
                         "stage_min": cuda_fr.STAGE_MIN}


def elementwise_shapes(pk, net, n: int, int_rate: float, imad_ns: float) -> dict:
    """One dense prove through ``record_elementwise``, one launch a call
    with a result.  Then each (field, op)'s three commonest shapes timed on
    the first call kept at that shape, its own operands: the device time a
    launch through the wrapper (the instance the prove takes), and in a
    small and in a staged launch, beside its bound there (each operand's
    distinct elements read once, the result written once; 4N^2 + N multiplies an element for
    ``mul``) and two floors: for ``mul`` the chain bound of one product
    (``cios_depth`` dependent multiply-adds of ``imad_ns`` each), and the
    device time of an empty launch, which only fewer launches can cut."""
    def prove():
        with msm_config(True):
            _reset_counts()
            dhyperplonk(n, pk, net)
            torch.cuda.synchronize()
    calls, keys, summary = record_elementwise(prove)
    launches = _counts()
    for key in ("fr_mul", "fr_add", "fr_sub"):
        made = sum(1 for name, _, out in calls if name == key and out.numel())
        if made != launches[key]:
            raise AssertionError(f"the prove launched {key} {launches[key]} times, "
                                 f"kept {made} calls with a result")
    hist = collections.Counter(keys)
    first = {}
    for k, (_, args, _) in zip(keys, calls):
        first.setdefault(k, args)
    lib = cuda_build.library("fr", cuda_fr._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    common = [(k, v) for fo in sorted({k[:2] for k in keys})
              for k, v in collections.Counter({k: v for k, v in hist.items()
                                               if k[:2] == fo}).most_common(3)]
    for key, count in common:
        field, op, sa, sb = key
        spec, a, b = first[key]
        kern = getattr(cuda_fr, op)
        m = torch.broadcast_shapes(a.shape, b.shape)[:-1].numel()
        muls = m * _mont_muls(spec.num_words) if op == "mul" else 0
        read = sum(math.prod(k for k, st in zip(x.shape, x.stride()) if st) for x in (a, b))
        bound, by = _bound_ms((read + m * spec.num_limbs) * 4, muls, int_rate)
        times = {
            "device_ms": _device_ms(lambda: kern(spec, a, b), "binary_kernel"),
            **{f"{how}_device_ms": _device_ms(
                lambda staged=staged: cuda_fr.run_binary(lib, op, spec, a, b, stream, staged),
                "binary_kernel") for how, staged in (("small", False), ("staged", True))}}
        chain = cios_depth(spec.num_words) * imad_ns * 1e-6 if op == "mul" else None
        rows.append({"field": field, "op": op, "shape": [list(sa), list(sb)],
                     "strides": [list(a.stride()), list(b.stride())],
                     "mode": cuda_fr.launch_mode(a, b), "calls_at_shape": count,
                     "calls": sum(v for k, v in hist.items() if k[:2] == (field, op)),
                     **{k: "not measured" if v is None else v for k, v in times.items()},
                     "bound_ms": bound, "bound_by": by, "chain_bound_ms": chain})
    empty = _device_ms(lambda: cuda_fr.empty_launch(torch.device("cuda")), "empty_kernel")
    return {**summary, "elementwise_at_commonest_shapes": rows,
            "empty_launch_device_ms": "not measured" if empty is None else empty}


def ladder_scalars(curve, m: int, L: int, seed: int) -> torch.Tensor:
    """m random standard-form scalars of L 16-bit limbs: field elements of
    Fr at its full width, else random limbs."""
    Fr = curve.fr
    if L == Fr.L:
        return Fr.decode(Fr.random((m,), seed))
    limbs = np.random.RandomState(seed).randint(0, 1 << 16, size=(m, L))
    return torch.from_numpy(limbs.astype(np.int32)).to(curve.device)


def nondense_shapes(pk, net, n: int, int_rate: float, lat_ms: float) -> dict:
    """One non-dense prove with the lanes and masked lanes of every
    ``add_masked`` call kept: the lane histogram, and at its four most
    frequent lane counts ``add_masked`` held against its plain version and
    timed (``_timed_row``) on random points (Z != 1) under a random mask
    with the mean masked share of the prove's calls at that count."""
    calls = _kept_shapes(pk, net, n, ("add_masked",), dense=False)
    hist = collections.Counter(m for _, (m, _) in calls)
    curve, spec = pk.curve, pk.curve.fq.spec
    rows = []
    for m, count in hist.most_common(4):
        masked = [k for _, (lanes, k) in calls if lanes == m]
        share = sum(masked) / (m * len(masked))
        p1 = curve.double(rand_points_flat(curve, m, 80))
        a2 = rand_points_flat(curve, m, 81)
        mask = torch.from_numpy(np.random.RandomState(82).random_sample(m) < share).to(curve.device)
        run = lambda: cuda_g1.add_masked(spec, p1, a2, mask)  # noqa: E731
        _equal(f"g1 add_masked at {m} lanes", run(), cuda_g1.add_masked.plain(spec, p1, a2, mask))
        k = int(mask.sum())
        bound = _g1_bound(11 * k, m * (1 + 2 * 288) + k * 288, ADD_DEPTH, int_rate, lat_ms)
        rows.append({"lanes": m, "launches": count, "mean_masked_share": share,
                     **_timed_row(run, MASKED_KERNEL, bound)})
    return {"add_masked_lanes_histogram": sorted(hist.items()),
            "add_masked_at_frequent_lanes": rows}


def profile_prove(pk, net, n: int, dense: bool = True) -> dict:
    """One prove in the MSM configuration ``dense`` under ``torch.profiler``
    (host and CUDA activity): the device time summed over every kernel and
    copy, its share of the same prove's wall time, the device time and
    launches of each G1 team kernel, and the kernels that took most of it,
    over what ran on the card (``_device_events``).  Without device events
    the share is None: not measured."""
    torch.cuda.synchronize()
    with msm_config(dense), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dhyperplonk(n, pk, net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = sorted(((e.key, _self_device_us(e) / 1e6, e.count) for e in _device_events(prof)),
                  key=lambda t: -t[1])
    busy = sum(t for _, t, _ in kern)
    if busy > wall:  # one stream: the card cannot be busy longer than the prove took
        raise AssertionError(f"profiled device time {busy} s exceeds the prove's {wall} s")
    of = lambda tag: [sum(t for k, t, _ in kern if tag in k),  # noqa: E731
                      sum(c for k, _, c in kern if tag in k)]
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if kern else None,
            "add_device_s_launches": of(ADD_KERNEL),
            "accumulate_device_s_launches": of(ACCUMULATE_KERNEL),
            "ladder_device_s_launches": of(LADDER_KERNEL),
            "add_masked_device_s_launches": of(MASKED_KERNEL),
            "horner_device_s_launches": of("horner_team_kernel"),
            "bucket_serial_device_s_launches": of("bucket_segment_kernel"),
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


# ---------------------------------------------------------------------------
# Phase 5b: the SRS cache, the bench entry's conformance and the
# measurement scripts
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _no_srs_build():
    """Inside the block ``benchmark_srs`` raises: an SRS must come from the cache."""
    build = params_module.benchmark_srs

    def refuse(*args):
        raise AssertionError("the benchmark SRS was built, not loaded from the cache")
    params_module.benchmark_srs = refuse
    try:
        yield
    finally:
        params_module.benchmark_srs = build


def _same_points(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def srs_cache_phase(launches: dict) -> dict:
    """The (16, 8) benchmark SRS through the disk cache (``SCZK_SRS_CACHE``
    on a temporary directory): its build, the file's write, size and load
    (host seconds, synchronised), every loaded point equal to the built
    one; then ``packed_proving_parameters`` with the variable set, which
    must load it (building raises), proves the flagship pin and comm,
    counted on its own."""
    n, l = PROVE["n"], PROVE["l"]
    curve = bls12_381_g1()
    pp = PackedSharingParams(curve.fr, l)
    report = {}
    with tempfile.TemporaryDirectory() as root:
        path = params_module.srs_cache_path(curve, n, pp, 1, root)
        timed = {}
        for step, fn in (("build", lambda: params_module.benchmark_srs(curve, n, pp)),
                         ("write", lambda: params_module.save_srs_cache(path, built)),
                         ("load", lambda: params_module.load_srs_cache(path, curve))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            timed[f"{step}_s"] = time.perf_counter() - t0
            if step == "build":
                built = out
        loaded = out
        report.update(timed, file=path.name, file_bytes=path.stat().st_size)
        for key in ("c", "d"):
            for field in ("powers_of_g", "root_levels", "packed_powers"):
                a, b = getattr(built[key], field), getattr(loaded[key], field)
                if (a is None) != (b is None) or not all(map(_same_points, a or [], b or [])):
                    raise AssertionError(f"the cached SRS's {key}.{field} differs from the built")
        del built, loaded
        net = PartyNet(8 * l, mode="leader")
        with _env("SCZK_SRS_CACHE", root), _no_srs_build():
            t0 = time.perf_counter()
            pk = packed_proving_parameters(n, l, net)
            torch.cuda.synchronize()
            report["setup_from_cache_s"] = time.perf_counter() - t0
    net.reset_comm()
    out, report["prove"] = _step("prove_cached_srs", lambda: dhyperplonk(n, pk, net), launches)
    _require("prove_cached_srs", launches, PROVE_DENSE_KERNELS)
    _check_pin(f"prove_n{n}_l{l}", proof_digest(pk.curve, out))
    _check_pin(f"prove_n{n}_l{l}_comm", _comm(net))
    return report


def conformance_phase() -> dict:
    """``bench --conformance`` on the card: the pinned (6, 1) prove must PASS."""
    out = bench_module.conformance("cuda")
    if out["verdict"] != "PASS":
        raise AssertionError(f"bench --conformance: {out}")
    return out


def _captured(main, argv) -> tuple[int, str, float]:
    """(exit code, standard output, host seconds) of a script's
    ``main(argv)``, run in this process."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def scripts_phase() -> dict:
    """The measurement scripts once each on the card, their output parsed:
    ``pin_digest`` at (16, 8) prints the flagship pin, ``sweep`` at
    ``SWEEP`` writes its CSV with the JAX script's columns, and
    ``profile_primitives`` (at (16, 8)) and ``g1_micro`` print a warm time
    for every row."""
    n, l = PROVE["n"], PROVE["l"]
    report = {}
    rc, out, dt = _captured(pin_digest.main, ["--n", str(n), "--l", str(l)])
    m = re.fullmatch(r"\((\d+), (\d+)\): 0x([0-9A-F]{16})", out.strip())
    if rc or not m or int(m.group(3), 16) != PINS[f"prove_n{n}_l{l}"]:
        raise AssertionError(f"pin_digest printed {out!r} (exit {rc})")
    report["pin_digest"] = {"line": out.strip(), "s": dt}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "sweep.csv")
        rc, out, dt = _captured(sweep.main, ["--suite", SWEEP["suite"], "--n", str(SWEEP["n"]),
                                             "--l", str(SWEEP["l"]), "--out", path])
        with open(path, newline="") as fh:
            rows = list(csv.DictReader(fh))
    if rc or len(rows) != 1 or tuple(rows[0]) != sweep.COLUMNS or rows[0]["backend"] != "cuda" \
            or not float(rows[0]["seconds"]) > 0 or not int(rows[0]["up_bytes"]) > 0:
        raise AssertionError(f"sweep wrote {rows} (exit {rc})")
    report["sweep"] = {"row": rows[0], "s": dt}
    for name, main, argv, want in (
            # 13 steps and the zerocheck layer at 2^11, 2^9 and 2^7
            ("profile_primitives", profile_primitives.main, ["--n", str(n), "--l", str(l)], 16),
            # the accumulate, the point adds, the ladders and the Horner shapes
            ("g1_micro", g1_micro.main, [], 2 + len(g1_micro.LADDER) + len(g1_micro.HORNER))):
        rc, out, dt = _captured(main, argv)
        rows = re.findall(r"^(\S.*?)\s+warm\s+([0-9.]+) ms", out, flags=re.M)
        if rc or len(rows) != want or not all(float(t) > 0 for _, t in rows):
            raise AssertionError(f"{name} printed {out!r} (exit {rc})")
        report[name] = {"warm_ms": {k.strip(): float(t) for k, t in rows}, "s": dt}
    return report


# ---------------------------------------------------------------------------
# Phase 8: the protocol layer
# ---------------------------------------------------------------------------
def _step(tag: str, fn, launches: dict):
    """``fn()`` once, with the counts set to 0 just before it and read just
    after; prints its host seconds (synchronised), launches per kernel and
    peak device memory on a line of its own.  Returns (result, that row)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches[tag] = _counts()
    row = {"step": tag, "host_s": dt, "launches": {k: v for k, v in launches[tag].items() if v},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps(row), flush=True)
    return out, row


def _require(tag: str, launches: dict, kernels):
    missing = [k for k in kernels if not launches[tag][k]]
    if missing:
        raise AssertionError(f"{tag}: kernels not launched: {missing}")


def _secrets(n_vars: int, seed: int) -> list:
    """tests/test_hyperplonk.py's honest secrets: 40 seeded bytes each, mod r."""
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(40), "little") % hc.R for _ in range(n_vars)]


def _level_scalar(factors, k: int, j: int) -> int:
    """Point j of tensor level k over ``factors``: bit t of j picks f_t or 1 - f_t."""
    w = 1
    for t in range(k):
        f = factors[t] % hc.R
        w = w * (f if (j >> t) & 1 else (1 - f) % hc.R) % hc.R
    return w


def _checked(k: int, size: int, seed: int) -> list:
    """Every index of a level up to SRS_FULL_LEVELS, else SRS_SAMPLED seeded ones."""
    if k <= SRS_FULL_LEVELS or size <= SRS_SAMPLED:
        return list(range(size))
    return sorted(int(i) for i in np.random.RandomState(seed * 1000 + k).choice(
        size, SRS_SAMPLED, replace=False))


HOST_WINDOW = 8  # bits a window of the host's fixed-base table


def _fixed_base_table() -> list:
    """d 2^(8 w) G1_GEN for every 8-bit window w and digit d, by the host's
    affine ``g1_add``."""
    table, base = [], hc.G1_GEN
    for _ in range(-(-hc.R.bit_length() // HOST_WINDOW)):
        row = [None]
        for _ in range(1, 1 << HOST_WINDOW):
            row.append(hc.g1_add(row[-1], base))
        table.append(row)
        base = hc.g1_add(row[-1], base)
    return table


def _host_mul(table: list, k: int):
    """G1_GEN times k on the host: one table entry added a window."""
    acc, w = None, 0
    while k:
        acc = hc.g1_add(acc, table[w][k & ((1 << HOST_WINDOW) - 1)])
        k >>= HOST_WINDOW
        w += 1
    return acc


def _hold_points(curve, jobs, table: list) -> int:
    """Each job (tag, points, {flat index: scalar}): the points at those
    indices equal G1_GEN times their scalars on the host by affine value,
    the first of each job by ``hc.g1_mul`` and the rest by the fixed-base
    table (the same group element, a twentieth of the host's time);
    returns the points held."""
    held = 0
    for tag, pts, scalars in jobs:
        idx = sorted(scalars)
        got = curve.to_affine_ints(map_points(lambda a: a.reshape(-1, a.shape[-1])[idx], pts))
        for n, (i, g) in enumerate(zip(idx, got)):
            ref = hc.g1_mul(hc.G1_GEN, scalars[i]) if n == 0 else _host_mul(table, scalars[i])
            if g != ref:
                raise AssertionError(f"{tag}: point {i} differs from the host's product")
        held += len(idx)
    return held


def check_srs(curve, pp, srs: dict, secrets: dict) -> dict:
    """Each SRS of (a) against the host: every point of its levels up to
    SRS_FULL_LEVELS (the root levels all) and SRS_SAMPLED seeded points of
    each higher level equal G1_GEN times the point's scalar on the host
    (``_hold_points``); returns the points held per SRS."""
    n_vars = len(secrets["c"])
    jobs = {}
    for name in ("c", "d"):
        s = secrets[name]
        factors = [s[n_vars - t - 1] for t in range(n_vars)]
        jobs[name] = [(f"{name} level {k}", lv, {
            j: _level_scalar(factors, k, j) for j in _checked(k, 1 << k, 1 + k)})
            for k, lv in enumerate(srs[name].powers_of_g)]
    d, s = srs["d"], secrets["d"]
    sbits = pp.n.bit_length() - 1
    jobs["d_root_levels"] = []
    for m_total, levels in d.root_levels.items():
        base = n_vars - m_total
        factors = [s[base + sbits - i - 1] for i in range(sbits)]
        jobs["d_root_levels"] += [(f"d root {m_total} level {k}", lv, {
            j: _level_scalar(factors, k, j) for j in range(1 << k)}) for k, lv in enumerate(levels)]
    s = secrets["c"]
    factors = [s[n_vars - t - 1] for t in range(n_vars)]
    mat = pp.pack_matrix()
    jobs["c_packed"] = []
    for k, lv in enumerate(srs["c_packed"].packed_powers):
        chunks = lv.x.shape[1]

        def share(flat, k=k, chunks=chunks):
            j, c = divmod(flat, chunks)
            return sum(int(mat[j, i]) * _level_scalar(factors, k, c * pp.l + i)
                       for i in range(pp.l) if c * pp.l + i < 1 << k) % hc.R
        jobs["c_packed"].append((f"c packed level {k}", lv, {
            f: share(f) for f in _checked(k, pp.n * chunks, 2 + k)}))
    table = _fixed_base_table()
    return {name: _hold_points(curve, j, table) for name, j in jobs.items()}


def hold_srs_ladder(curve, secrets: list) -> dict:
    """The SRS build's ladder on LADDER_SLICE lanes of the top level (the
    generator times the level's scalars, from ``secrets``) against its plain
    version, both timed."""
    spec = curve.fq.spec
    n_vars = len(secrets)
    factors = [secrets[n_vars - t - 1] for t in range(n_vars)]
    sc = curve.fr.decode(curve.fr.array_from_ints(
        [_level_scalar(factors, n_vars, j) for j in range(LADDER_SLICE)]))
    g = map_points(lambda a: a.expand(sc.shape[0], a.shape[-1]),
                   curve.from_affine_ints([hc.G1_GEN]))
    run = lambda: cuda_g1.scalar_mul(spec, g, sc)  # noqa: E731
    t0 = time.perf_counter()
    ref = cuda_g1.scalar_mul.plain(spec, g, sc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    return {"lanes": sc.shape[0], "max_abs_err": _equal("g1 scalar_mul (SRS top level)", run(),
                                                         ref),
            "ms": _ms(run, reps=3), "plain_ms": plain_ms}


def _layout(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.stride()
    if isinstance(a, (tuple, list)):
        return tuple(_layout(x) for x in a)
    return a if isinstance(a, (int, float, str)) else type(a).__name__


def _snap_layout(a):
    """``_view_snapshot`` of every tensor in ``a`` (nested tuples, lists and
    points kept)."""
    if isinstance(a, torch.Tensor):
        return _view_snapshot(a)
    if isinstance(a, PointJ):
        return PointJ(*(_snap_layout(x) for x in a))
    if isinstance(a, (tuple, list)):
        return type(a)(_snap_layout(x) for x in a)
    return a


class _FirstOfLayout:
    """A ``keep`` for ``_Recorder``: the first field- and phase-kernel call
    at each operand layout (shapes and strides) and the first call of each
    G1 kernel (their plain versions walk a ladder, a Horner chain or an
    accumulate's steps one at a time: seconds a call), operands as laid out
    and the result as it was."""

    def __init__(self):
        self.seen = set()

    def __call__(self, calls: list, entry):
        name, args, out = entry
        key = name if name.startswith("g1_") else (name, _layout(args))
        if key not in self.seen:
            self.seen.add(key)
            calls.append((name, _snap_layout(args), _snapshot(out)))


class _ReplayEachLayout:
    """A ``keep`` for ``_Recorder`` that files nothing: the first call of
    every field and phase kernel at each operand layout, and of every G1
    kernel at each layout inside a c-side commit or open
    (``_c_side_g1``), is replayed through the plain version as it returns
    (``replay``, which raises on a difference); the ladder's first call
    alone (its plain version walks the scalar's bits, ~10 s a call).
    ``seen`` counts the calls replayed per kernel, and ``seconds`` the host
    seconds they took."""

    def __init__(self, by_name=("g1_scalar_mul",)):
        self.by_name, self.keys, self.seen, self.seconds = by_name, set(), {}, {}
        self.c_side = 0  # depth of c-side calls the prover is inside

    def __call__(self, calls: list, entry):
        name, args, _ = entry
        if name.startswith("g1_") and name not in self.by_name and not self.c_side:
            return
        key = name if name in self.by_name else (name, _layout(args))
        if key not in self.keys:
            self.keys.add(key)
            t0 = time.perf_counter()
            replay([entry])
            self.seen[name] = self.seen.get(name, 0) + 1
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


C_SIDE = ("c_commit", "c_open", "c_open_many")


@contextlib.contextmanager
def _c_side_g1(keep: _ReplayEachLayout):
    """The prover's c-side commits and opens (``C_SIDE``) mark ``keep``
    while they run: at l > 1 the verifier cannot pair the c_opens, so
    nothing but a replay holds their G1 results; the d side's it pairs."""
    saved = {name: getattr(collab_module, name) for name in C_SIDE}

    def marked(fn):
        def call(*args, **kwargs):
            keep.c_side += 1
            try:
                return fn(*args, **kwargs)
            finally:
                keep.c_side -= 1
        return call
    for name, fn in saved.items():
        setattr(collab_module, name, marked(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(collab_module, name, fn)


@contextlib.contextmanager
def sampled_recording(g1: bool = True, keep=None):
    """Keep the kernel calls inside the block that ``keep`` samples
    (``_FirstOfLayout`` by default); with ``g1`` False, the field and
    phase calls alone."""
    calls, keep = [], keep or _FirstOfLayout()
    fr_module.cuda_fr = _Recorder(cuda_fr, "fr_", ("mul", "add", "sub"), calls, keep=keep)
    sumcheck_module.cuda_sumcheck = _Recorder(cuda_sumcheck, "sumcheck_", ("product_phase",), calls,
                                              keep=keep)
    if g1:
        g1_module.cuda_g1 = msm_module.cuda_g1 = _Recorder(cuda_g1, "g1_", G1_WRAPPERS, calls,
                                                           keep=keep)
    try:
        yield calls
    finally:
        fr_module.cuda_fr, sumcheck_module.cuda_sumcheck = cuda_fr, cuda_sumcheck
        g1_module.cuda_g1 = msm_module.cuda_g1 = cuda_g1


def _pairing_s() -> float:
    return sum(dt for label, dt in timer.records() if label == "Pairing check")


def _timed_verify(fn) -> dict:
    """``fn()`` (a verifier call), synchronised: its result, its host
    seconds, and those of them in the host pairing checks."""
    timer.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, fails = fn()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    pairing = _pairing_s()
    return {"ok": ok, "failures": fails, "verify_s": total, "pairing_s": pairing,
            "device_side_s": total - pairing}


def srs_paths(curve, pp, launches: dict) -> tuple[dict, dict]:
    """(a): the honest SRSs of n + 2 variables built on the card, each a
    step of its own, held against the host; then the top level's ladder on
    a slice against its plain version.  Returns (SRSs, report)."""
    n_vars = PROTOCOL["n"] + 2
    secrets = {k: _secrets(n_vars, seed) for k, seed in PROTOCOL["srs_seeds"].items()}
    srs, report = {}, {}
    srs["d"], report["srs_d"] = _step("srs_d", lambda: srs_from_secret(
        curve, hc.G1_GEN, hc.G2_GEN, secrets["d"], n_parties=pp.n), launches)
    srs["c"], report["srs_c"] = _step("srs_c", lambda: srs_from_secret(
        curve, hc.G1_GEN, hc.G2_GEN, secrets["c"]), launches)
    srs["c_packed"], report["srs_c_packed"] = _step("srs_c_packed", lambda: srs_from_secret(
        curve, hc.G1_GEN, hc.G2_GEN, secrets["c"], pp=pp), launches)
    for tag, kernels in (("srs_d", SRS_KERNELS), ("srs_c", SRS_KERNELS),
                         ("srs_c_packed", SRS_PACKED_KERNELS)):
        _require(tag, launches, kernels)
    t0 = time.perf_counter()
    report["points_held"] = check_srs(curve, pp, srs, secrets)
    report["host_check_s"] = time.perf_counter() - t0
    report["top_level_ladder"] = hold_srs_ladder(curve, secrets["c"])
    return srs, report


def _sim_prove(tag: str, curve, pp, srs: dict, launches: dict, timed: bool):
    """``dhyperplonk`` in sim mode, all 8l parties on the card, on consistent
    shares with the honest SRSs ``srs`` (c packed, d), a step; with
    ``timed``, ``SPLIT["repeat"]`` more proves, warm and synchronised, as
    phase 8(b2) times its split proves.  Returns (report, pk, g, net,
    proof)."""
    n = PROTOCOL["n"]
    net = PartyNet(pp.n, mode="sim")
    pk, g = consistent_proving_parameters(n, pp.l, net, {"c": srs["c_packed"], "d": srs["d"]},
                                          curve=curve)
    proof, row = _step(f"{tag}_prove", lambda: dhyperplonk(n, pk, net), launches)
    _require(f"{tag}_prove", launches, PROTOCOL_PROVE_KERNELS)
    report = {"prove": row, "parties": pp.n, "l": pp.l,
              "digest": f"0x{proof_digest(curve, proof):016x}", "comm": list(_comm(net))}
    if timed:  # the net's counters are the first prove's again after
        runs, snap = [], net.comm_snapshot()
        for _ in range(SPLIT["repeat"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dhyperplonk(n, pk, net)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        net.comm_restore(snap)
        report["prove_median_s"], report["prove_runs_s"] = statistics.median(runs), runs
    return report, pk, g, net, proof


def _sim_prove_verify(tag: str, curve, pp, srs: dict, launches: dict, replayed: dict,
                      hold: bool = True, configs=()):
    """``dhyperplonk`` in sim mode, all 8l parties on the card, on consistent
    shares with the honest SRSs ``srs`` (c plain, c packed, d), then the
    complete verifier with its pairings, each a step.  With ``hold``, one
    more prove, which must prove the same bundle, whose field and phase
    calls at each operand layout and G1 calls at each layout of its c-side
    commits and opens (``_ReplayEachLayout``) are replayed through the plain
    versions as they return, and the verifier's sampled kernel calls
    replayed.  Then one prove in each engine configuration of ``configs``
    (``ENGINE_CONFIGS``), counted on its own, which must give the default
    prove's bundle, which the verifier holds, and its comm; no kernel call
    of these is replayed.  Returns (report, the verifier's verdict, the
    verifier without pairings, a gate-section check on a corrupted copy)."""
    n = PROTOCOL["n"]
    report, pk, g, net, proof = _sim_prove(tag, curve, pp, srs, launches, timed=hold)
    digest, comm = proof_digest(curve, proof), _comm(net)
    if hold:
        keep = _ReplayEachLayout()
        t0 = time.perf_counter()
        with sampled_recording(keep=keep), _c_side_g1(keep):
            again = dhyperplonk(n, pk, net)
        torch.cuda.synchronize()
        report["prove_replay_s"] = time.perf_counter() - t0
        if proof_digest(curve, again) != proof_digest(curve, proof):
            raise AssertionError(f"{tag}: the replayed prove made another bundle")
        del again
        replayed[f"{tag}_prove"] = report["prove_calls_replayed"] = keep.seen
        report["prove_replay_s_by_kernel"] = keep.seconds
        missing = [k for k, v in launches[f"{tag}_prove"].items() if v and not keep.seen.get(k)]
        if missing:
            raise AssertionError(f"{tag}: no call of {missing} replayed")
    for name in configs:
        with ENGINE_CONFIGS[name]():
            net.reset_comm()
            out, report[f"prove_{name}"] = _step(f"{tag}_prove_{name}",
                                                 lambda: dhyperplonk(n, pk, net), launches)
        _require(f"{tag}_prove_{name}", launches, CONFIG_PROVE_KERNELS[name])
        got = (proof_digest(curve, out), _comm(net))
        if got != (digest, comm):
            raise AssertionError(f"{tag} prove with {name}: digest 0x{got[0]:016x} and comm "
                                 f"{got[1]}, not the default 0x{digest:016x} and {comm}")
        del out
    args = (pp, srs["c"], srs["d"], proof, g, pk.challenge, pk.challenge_r2,
            eq_top_table(curve.fr, pp.n))
    with (sampled_recording() if hold else contextlib.nullcontext([])) as kept:
        verdict, report["verify_step"] = _step(
            f"{tag}_verify", lambda: _timed_verify(lambda: verify_dhyperplonk(*args)), launches)
    _require(f"{tag}_verify", launches, VERIFY_KERNELS)
    if hold:
        t0 = time.perf_counter()
        replayed[f"{tag}_verify"] = replay(kept)[0]
        report["verify_replay_s"] = time.perf_counter() - t0
    del kept
    report["verify"] = verdict

    def corrupted():
        bad = list(proof[0][0])
        bad[1] = bad[1].clone()
        bad[1][:, 0, 1, 0] += 1  # tests/test_hyperplonk.py:248
        return verify_dhyperplonk_gate(pp, srs["c"], srs["d"], (bad, proof[0][1]), g["eq"],
                                       pk.challenge, pairings=False)
    return report, verdict, lambda: verify_dhyperplonk(*args, pairings=False), corrupted


def sim_path(curve, pp, srs: dict, launches: dict, replayed: dict) -> dict:
    """(b): the sim-mode prove with all 8l = 64 parties on the card,
    verified.  Its c_opens' last log2(l) proofs are the reference's local
    MSMs over the packed base (dpoly_comm.rs:454-456), so at l > 1 the
    verifier's c_open pairings fail, as the JAX package's do
    (``C_OPEN_PHASE2_FAILURES``); every other check must pass, the whole
    verifier without pairings must accept, and a copy with one gate
    message changed must fail naming gate[1] in every failure.  Then the
    same prove at l = 1 (8 parties, c_opens without those rounds) on SRSs
    of the same secrets, which the complete verifier with its pairings
    must accept.  The l = 8 prove runs again in each other engine
    configuration (``ENGINE_CONFIGS``) to the same bundle and comm."""
    report, verdict, unpaired, corrupted = _sim_prove_verify("sim", curve, pp, srs, launches,
                                                             replayed, configs=ENGINE_CONFIGS)
    n = PROTOCOL["n"]
    if (verdict["ok"], verdict["failures"]) != (False, C_OPEN_PHASE2_FAILURES):
        raise AssertionError(f"sim-mode (n={n}, l={pp.l}) bundle: {verdict['failures']}")
    report["verify_without_pairings"] = unpaired()
    if report["verify_without_pairings"] != (True, []):
        raise AssertionError(f"sim-mode (n={n}, l={pp.l}) bundle fails without pairings: "
                             f"{report['verify_without_pairings']}")
    ok, fails = corrupted()
    if ok or not fails or not all("gate[1]" in f for f in fails):
        raise AssertionError(f"the corrupted gate message was not caught as gate[1]: {fails}")
    report["corrupted_failures"] = fails

    pp1 = PackedSharingParams(curve.fr, 1)
    srs1 = {"c": srs["c"]}
    srs1["d"], report["srs_d_8"] = _step("srs_d_8", lambda: srs_from_secret(
        curve, hc.G1_GEN, hc.G2_GEN, _secrets(n + 2, PROTOCOL["srs_seeds"]["d"]),
        n_parties=pp1.n), launches)
    srs1["c_packed"], report["srs_c_packed_l1"] = _step("srs_c_packed_l1", lambda: srs_from_secret(
        curve, hc.G1_GEN, hc.G2_GEN, _secrets(n + 2, PROTOCOL["srs_seeds"]["c"]), pp=pp1),
        launches)
    report["l1"], verdict, _, _ = _sim_prove_verify("sim_l1", curve, pp1, srs1, launches, replayed,
                                                    hold=False)
    if (verdict["ok"], verdict["failures"]) != (True, []):
        raise AssertionError(f"sim-mode (n={n}, l=1) bundle fails: {verdict['failures']}")
    return report


def _proves(tag: str, fn, launches: dict, replayed: dict, net=None, repeat: int = 3,
            g1: bool = False) -> dict:
    """A warm-up, ``repeat`` synchronised proves (median), then one counted
    prove whose sampled kernel calls (``_FirstOfLayout``; G1 calls only
    with ``g1``) are replayed through the plain versions; its digest (and
    comm, of one prove, with ``net``) against the pins."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    if net is not None:
        net.reset_comm()
    with sampled_recording(g1) as kept:
        out, row = _step(tag, fn, launches)
    _require(tag, launches, PROTOCOL_PROVE_KERNELS)
    t0 = time.perf_counter()
    replayed[tag], _ = replay(kept)
    replay_s = time.perf_counter() - t0
    del kept
    key = f"{tag}_n{PROTOCOL['n']}" + ("" if net is None else f"_l{PROTOCOL['l']}")
    digest = proof_digest(g1_module.bls12_381_g1(), out)
    _check_pin(key, digest)
    report = {"median_s": statistics.median(runs), "runs_s": runs, "counted": row,
              "digest": f"0x{digest:016x}", "calls_replayed": replayed[tag], "replay_s": replay_s}
    if net is not None:
        _check_pin(f"{key}_comm", _comm(net))
        report["comm"] = list(_comm(net))
    return report


def local_paths(curve, c_plain, launches: dict, replayed: dict) -> dict:
    """(c): the local provers at n = 16 on the example's random SRS, pinned
    and timed, and one prove each with ``SCZK_MXU=1``, pinned; then
    ``local_hyperplonk`` on the honest c-SRS of (a), which
    ``verify_local_hyperplonk`` must accept."""
    n = PROTOCOL["n"]
    srs = srs_random(curve, n + 2, PROTOCOL["local_srs_seed"])
    # G1 calls held in the local prove only: its MSMs of 2^16 and 2^18
    # points are this phase's new G1 shapes (local++ makes the same ones)
    report = {key: _proves(key, lambda fn=fn: fn(n, srs), launches, replayed,
                           g1=key == "local") for key, fn in LOCAL_PROVERS.items()}
    for key, fn in LOCAL_PROVERS.items():  # the int8 engine: one prove each, pinned
        with mxu_config():
            out, report[f"{key}_mxu"] = _step(f"{key}_mxu", lambda fn=fn: fn(n, srs), launches)
        _require(f"{key}_mxu", launches, CONFIG_PROVE_KERNELS["mxu"])
        _check_pin(f"{key}_n{n}", proof_digest(curve, out))
        del out
    del srs
    ins = local_inputs(curve.fr, n)
    proof = local_hyperplonk(n, c_plain, ins)
    verdict = _timed_verify(lambda: verify_local_hyperplonk(n, c_plain, proof, ins))
    if (verdict["ok"], verdict["failures"]) != (True, []):
        raise AssertionError(f"local (n={n}) bundle on the honest SRS fails: {verdict['failures']}")
    report["honest_verify"] = verdict
    return report


def variant_paths(launches: dict, replayed: dict) -> dict:
    """(d): the three variants at (16, 8) in leader mode, pinned and timed;
    their G1 calls are the flagship prove's steps at its shapes, which
    phases 4 and 5 hold, so their field and phase calls are replayed.  Then
    one prove of each in each other engine configuration
    (``ENGINE_CONFIGS``), counted on its own, against the same pins."""
    n, l = PROTOCOL["n"], PROTOCOL["l"]
    net = PartyNet(8 * l, mode="leader")
    pk = packed_proving_parameters(n, l, net)
    report = {key: _proves(key, lambda fn=fn: fn(n, pk, net), launches, replayed, net=net)
              for key, fn in VARIANTS.items()}
    for name, config in ENGINE_CONFIGS.items():
        for key, fn in VARIANTS.items():
            tag, pin = f"{key}_{name}", f"{key}_n{n}_l{l}"
            with config():
                net.reset_comm()
                out, report[tag] = _step(tag, lambda fn=fn: fn(n, pk, net), launches)
            _require(tag, launches, CONFIG_PROVE_KERNELS[name])
            _check_pin(pin, proof_digest(pk.curve, out))
            _check_pin(f"{pin}_comm", _comm(net))
            del out
    return report


def split_world() -> tuple[int, str, str]:
    """(ranks, backend, their device) of the split prove: four NCCL ranks,
    one a card, with four cards or more; two with two or three; with one
    card, four gloo ranks sharing it."""
    cards = torch.cuda.device_count()
    if cards >= 4:
        return 4, "nccl", "cuda"
    if cards >= 2:
        return 2, "nccl", "cuda"
    return 4, "gloo", "cuda:0"


def _split_prove(name: str, fn, n: int, pk, net: PartyNet, repeat: int) -> tuple[dict, dict]:
    """On one rank: ``repeat`` synchronised proves after a warm-up (each
    started together on every rank), then one more with the counts set to
    0 just before it and read just after and the peak memory reset; the
    whole bundle's digest (rank 0) and the comm.  Returns (report, counts)."""
    dev = pk.curve.device
    runs = []
    for i in range(repeat + 1):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(n, pk, net)
        torch.cuda.synchronize(dev)
        if i:
            runs.append(time.perf_counter() - t0)
    net.reset_comm()
    dist.barrier()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    out = fn(n, pk, net)
    torch.cuda.synchronize(dev)
    counted_s = time.perf_counter() - t0
    counts = _counts()
    row = {"median_s": statistics.median(runs) if runs else None, "runs_s": runs,
           "counted_s": counted_s, "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "comm": list(_comm(net)), "launches": {k: v for k, v in counts.items() if v}}
    whole = sharding.gather_bundle(out, net, name, check_leader=True)
    if net.rank == 0:
        row["digest"] = f"0x{proof_digest(pk.curve, whole):016x}"
    return row, counts


def _split_rank(group, dev, srs_path: str, small: tuple) -> dict:
    """One rank of the split phase: the honest SRSs from ``srs_path`` (its
    rows of the packed levels, cut on the host), its rows of phase 8(b)'s
    consistent inputs, and the (16, 8) ``dhyperplonk`` (``_split_prove``);
    then the three variants at ``small`` = (n, l) on the seeded inputs,
    one counted prove each."""
    curve = bls12_381_g1(dev)
    n, l = PROTOCOL["n"], PROTOCOL["l"]
    net = PartyNet(8 * l, "sim", group=group)
    t0 = time.perf_counter()
    srs = params_module.load_srs_cache(Path(srs_path), curve, net)
    if srs is None:
        raise RuntimeError(f"rank {net.rank} could not read the SRS file {srs_path}")
    pk, _ = consistent_proving_parameters(n, l, net, srs, curve=curve)
    torch.cuda.synchronize(dev)
    out = {"rank": net.rank, "device": str(dev), "parties": [net.party_offset, net.local_parties],
           "setup_s": time.perf_counter() - t0}
    out["dhyperplonk"], out["launches"] = _split_prove("dhyperplonk", dhyperplonk, n, pk, net,
                                                       SPLIT["repeat"])
    del pk, srs
    ns, ls = small
    net = PartyNet(8 * ls, "sim", group=group)
    pk = packed_proving_parameters(ns, ls, net, curve=curve)
    for key, fn in VARIANTS.items():
        out[key], _ = _split_prove(fn.__name__, fn, ns, pk, net, 0)
    return out


def split_phase(curve, srs: dict, sim: dict, launches: dict) -> dict:
    """Phase 8(b2): the sim (16, 8) prove of (b) with its 64 parties spread
    over ranks (``split_world``), each rank proving its parties' share;
    rank 0's gathered bundle must have (b)'s digest, and every rank's comm
    (b)'s.  Each rank must launch every kernel of the sim prove.  Then the
    three variants at ``SPLIT``'s (n, l) in the same world, each against
    its single-process sim run made here first."""
    world, backend, device = split_world()
    ns, ls = SPLIT["n"], SPLIT["l"]
    refs, net = {}, PartyNet(8 * ls, "sim")
    pk = packed_proving_parameters(ns, ls, net, curve=curve)
    for key, fn in VARIANTS.items():
        net.reset_comm()
        refs[key] = (f"0x{proof_digest(curve, fn(ns, pk, net)):016x}", list(_comm(net)))
    del pk
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "srs.pkl"
        params_module.save_srs_cache(path, {"c": srs["c_packed"], "d": srs["d"]})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = sharding.run_ranks(_split_rank, world, backend, device,
                                   args=(str(path), (ns, ls)), timeout=SPLIT["timeout_s"])
        wall = time.perf_counter() - t0
    want = (sim["digest"], sim["comm"])
    got = (ranks[0]["dhyperplonk"]["digest"], ranks[0]["dhyperplonk"]["comm"])
    if got != want:
        raise AssertionError(f"the split (16, 8) prove gave {got}, not phase 8(b)'s {want}")
    for r in ranks:
        if r["dhyperplonk"]["comm"] != sim["comm"]:
            raise AssertionError(f"rank {r['rank']}: comm {r['dhyperplonk']['comm']}, "
                                 f"not {sim['comm']}")
        tag = f"split_r{r['rank']}"
        launches[tag] = r["launches"]
        _require(tag, launches, PROTOCOL_PROVE_KERNELS)
        for key, (digest, comm) in refs.items():
            if r[key]["comm"] != comm or r["rank"] == 0 and r[key]["digest"] != digest:
                raise AssertionError(f"rank {r['rank']}: split {key} at ({ns}, {ls}) gave "
                                     f"{r[key].get('digest')} and {r[key]['comm']}, "
                                     f"not {digest} and {comm}")
    return {"world_size": world, "backend": backend,
            "cards_used": len({r["device"] for r in ranks}),
            "prove_median_s_by_rank": [r["dhyperplonk"]["median_s"] for r in ranks],
            "prove_runs_s_by_rank": [r["dhyperplonk"]["runs_s"] for r in ranks],
            "peak_bytes_by_rank": [r["dhyperplonk"]["peak_bytes"] for r in ranks],
            "setup_s_by_rank": [r["setup_s"] for r in ranks],
            "parties_by_rank": [r["parties"] for r in ranks],
            "digest": ranks[0]["dhyperplonk"]["digest"], "comm": ranks[0]["dhyperplonk"]["comm"],
            "launches_by_rank": [r["dhyperplonk"]["launches"] for r in ranks],
            "single_process_prove_s": sim["prove"]["host_s"],
            "single_process_median_s": sim.get("prove_median_s"),
            "single_process_peak_bytes": sim["prove"]["peak_bytes"],
            "variants": {key: {"n": ns, "l": ls, "digest": refs[key][0], "comm": refs[key][1],
                               "counted_s_by_rank": [r[key]["counted_s"] for r in ranks]}
                         for key in VARIANTS},
            "wall_s": wall}


def split_alone() -> dict:
    """Phase 8(b2) on its own, after a build: (a)'s SRSs and (b)'s timed sim
    prove, its reference (without (b)'s replay and verifier), then the
    split phase; returns its report."""
    curve = bls12_381_g1()
    pp = PackedSharingParams(curve.fr, PROTOCOL["l"])
    launches = {}
    srs, _ = srs_paths(curve, pp, launches)
    sim = _sim_prove("sim", curve, pp, srs, launches, timed=True)[0]
    report = split_phase(curve, srs, sim, launches)
    print(json.dumps({"split": report}), flush=True)
    return report


def protocol_phase(launches: dict, replayed: dict) -> dict:
    """Phase 8: (a) the honest SRSs, (b) the sim-mode prove verified, (b2)
    the same prove split over ranks, (c) the local provers, (d) the three
    variants; each step's report printed on a line of its own."""
    curve = bls12_381_g1()
    pp = PackedSharingParams(curve.fr, PROTOCOL["l"])
    srs, report = srs_paths(curve, pp, launches)
    print(json.dumps({"protocol_srs": report}), flush=True)
    out = {"srs": report, "sim": sim_path(curve, pp, srs, launches, replayed)}
    print(json.dumps({"protocol_sim": out["sim"]}), flush=True)
    out["split"] = split_phase(curve, srs, out["sim"], launches)
    print(json.dumps({"split": out["split"]}), flush=True)
    del srs["d"], srs["c_packed"]
    out["local"] = local_paths(curve, srs["c"], launches, replayed)
    print(json.dumps({"protocol_local": out["local"]}), flush=True)
    del srs
    out["variants"] = variant_paths(launches, replayed)
    print(json.dumps({"protocol_variants": out["variants"]}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    start = time.perf_counter()

    def stamp(phase: str):  # the script's wall seconds at the end of each phase
        print(json.dumps({"phase_done": phase, "wall_s": time.perf_counter() - start}),
              flush=True)

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

    stamp("1")

    # 2. kernels against their plain versions
    fr_rows = check_elementwise(F, 1 << 20, int_rate)
    strided_rows = check_strided(F, int_rate)
    fq_rows = check_elementwise(Fq, 1 << 20, int_rate)
    print(json.dumps({"fq_instances": fq_rows}), flush=True)
    curve = bls12_381_g1()
    lat_ms, chain_diag = chain_latency(curve)
    imad_ns = chain_diag["imad_wide_latency_ns"]
    phase_err, phase_held = check_phase(F)
    phase_rows = [time_phase(F, B, M, int_rate, imad_ns, plain=B * M <= 1 << 16)
                  for B, M in PHASE_TIMED]
    phase_row = dict(phase_rows[0], max_abs_err=phase_err)
    print(json.dumps({"phase_held": phase_held, "phase_timed": phase_rows, **fr_chain(F)}),
          flush=True)

    # G1 kernels against their plain versions (phase 2, continued)
    g1_rows, collision = check_g1(curve, int_rate, lat_ms)
    print(json.dumps({**chain_diag, **collision, **check_chain(curve)}), flush=True)

    stamp("2")

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
    for name in ("fr_mul", "fr_add", "fr_sub", "sumcheck_product_phase"):
        if replayed["gate_identity"].get(name, 0) != launches["gate_identity"][name]:
            raise AssertionError(f"{name}: {launches['gate_identity'][name]} launches, "
                                 f"{replayed['gate_identity'].get(name, 0)} calls replayed")
    print(json.dumps({"main_path_replayed": replayed["gate_identity"]}), flush=True)
    paths = {"gate_identity_ms": _host_ms(gate, 5), "gate_comm": list(net.comm(0))}

    stamp("3")

    # 4. the MSM paths of the prove, each counted on its own
    _reset_counts()
    bases = srs_bases(curve)
    torch.cuda.synchronize()
    launches["srs_bases"] = _counts()
    if launches["srs_bases"]["g1_scalar_mul"] != SRS_LADDERS:
        raise AssertionError(f"the SRS bases launched {launches['srs_bases']['g1_scalar_mul']} "
                             f"ladders, not {SRS_LADDERS}")
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

    stamp("4")

    # 5. the main path: the prove at n = 16, l = 8 in both MSM
    # configurations, and the (6, 1) prove
    prove = prove_phase(launches, replayed, int_rate, lat_ms, imad_ns)
    dense = {k: launches["prove"][k] for k in PROVE_G1_LAUNCHES}
    if dense != PROVE_G1_LAUNCHES:
        raise AssertionError(f"the prove launched {dense}, not {PROVE_G1_LAUNCHES}")
    nondense = {k: launches["prove_nondense"][k] for k in PROVE_NONDENSE_G1_LAUNCHES}
    if nondense != PROVE_NONDENSE_G1_LAUNCHES:
        raise AssertionError(f"the non-dense prove launched {nondense}, "
                             f"not {PROVE_NONDENSE_G1_LAUNCHES}")
    print(json.dumps({"chain_summary": {
        "fq_product_cc_chain_us": chain_diag["fq_product_cc_chain_us"],
        "fq_product_fmul_chain_us": chain_diag["fq_product_fmul_chain_us"],
        "fq_product_chain_bound_us": chain_diag["fq_product_chain_bound_us"],
        "prove_median_s": prove["value"], "prove_runs_s": prove["runs"],
        "fr_copies_per_prove": prove["prove_fr_copies"],
        "fr_mul_launches_per_prove": launches["prove"]["fr_mul"],
        "profiled_device_busy_s": prove["profile"]["device_busy_s"],
        "profiled_busy_share": prove["profile"]["busy_share"],
        **{f"{k}_device_s_launches": prove["profile"][f"{k}_device_s_launches"]
           for k in ("add", "accumulate", "horner", "bucket_serial", "ladder")},
        "nondense_profiled_device_busy_s": prove["profile_nondense"]["device_busy_s"],
        "nondense_profiled_busy_share": prove["profile_nondense"]["busy_share"],
        "nondense_add_masked_device_s_launches":
            prove["profile_nondense"]["add_masked_device_s_launches"],
        "launches_per_prove": dense, "nondense_launches_per_prove": nondense}}), flush=True)
    prove["n6_l1_digests"] = small_prove()
    print(json.dumps({"prove": prove}), flush=True)
    print(json.dumps({"mxu": mxu_paths(F, launches)}), flush=True)
    micro = mxu_micro.run("cuda")
    if not micro[4]["equal_to_mxu"]:
        raise AssertionError("mxu_micro: the int8 product phase differs from the phase kernel")
    print(json.dumps({"mxu_micro": micro}), flush=True)
    print(json.dumps({"exp_fieldmul": fieldmul_path(launches)}), flush=True)

    stamp("5")

    # 5b. the SRS cache, the bench entry's conformance and the measurement
    # scripts
    t0 = time.perf_counter()
    print(json.dumps({"srs_cache": srs_cache_phase(launches)}), flush=True)
    print(json.dumps({"conformance": conformance_phase()}), flush=True)
    print(json.dumps({"scripts": scripts_phase(), "phase_5b_s": time.perf_counter() - t0}),
          flush=True)

    stamp("5b")

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

    stamp("6")

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
    del net, opened, mono

    stamp("7")

    # 8. the protocol layer: honest SRSs, the sim-mode prove verified, the
    # local provers and the three variants
    t0 = time.perf_counter()
    protocol_phase(launches, replayed)
    print(json.dumps({"protocol_phase_s": time.perf_counter() - t0}), flush=True)

    stamp("8")

    # 9. kernel table: launches summed over the paths (gate identity, SRS
    # bases, c_commit, d_commit, c_open, each also non-dense, the prove in
    # both MSM configurations and with SCZK_MXU=1, the SCZK_MXU gate
    # identity, exp_fieldmul, and phase 8's steps), each counted on its own
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
    if prove["prove_fr_copies"]:
        raise AssertionError(f"the elementwise wrapper copied {prove['prove_fr_copies']} "
                             "operands in the dense prove")
    rows = {f"fr_{r['op']}": r for r in fr_rows}
    phase_attrs = cuda_sumcheck.attributes()
    rows["sumcheck_product_phase"] = dict(phase_row, **phase_attrs["cluster"],
                                          head_kernel=phase_attrs["head"])
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
        if "device_ms" in r:  # the kernel's own time where events also hold the host's
            row["device_ms"] = r["device_ms"]
        # the phase kernel's launch; the elementwise kernels' unstaged time and staged registers
        for key in ("cluster", "smem_bytes", "head_kernel",
                    "unstaged_device_ms", "staged_registers", "staged_spill_bytes"):
            if key in r:
                row[key] = r[key]
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
