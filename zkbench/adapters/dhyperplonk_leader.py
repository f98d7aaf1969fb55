"""The port's collaborative HyperPlonk prover as one leader of a committee.

Set-up takes the benchmark SRS (from the configuration's fixed seed)
through the port's disk cache, ``cached_benchmark_srs``, under the cache
directory the harness gives: the first run of a checkout builds it on the
device and writes the file, every later run loads it.  It holds the run's
fixed tables; ``prove`` wraps a job's tables into the port's
``PackedProvingParameters`` and calls ``dhyperplonk`` in ``leader`` mode on
a fresh ``PartyNet``.  Returns the bundle and party 0's (bytes sent, bytes
received, rounds).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import (PackedProvingParameters,
                                                                        cached_benchmark_srs,
                                                                        srs_cache_path)
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

SPANS = {"wire": ("Wire identity",), "commit_open": ("Commit", "Open")}
"""The program's spans (``utils/timer.py`` labels) each step metric reads."""


class System:
    def __init__(self, cfg: dict, traffic: dict, static: dict, device, cache_dir):
        self.n = traffic["gates_log2"]
        self.curve = bls12_381_g1(device)
        self.pp = PackedSharingParams(self.curve.fr, cfg["l"])
        self.N = cfg["N"]
        srs_dir = cache_dir / "srs"
        cached = srs_cache_path(self.curve, self.n, self.pp, cfg["srs_seed"], srs_dir).exists()
        t = time.perf_counter()
        srs = cached_benchmark_srs(self.curve, self.n, self.pp, cfg["srs_seed"], srs_dir)
        print(f"SRS {'loaded' if cached else 'built and written'} in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        self.srs_c, self.srs_d = srs["c"], srs["d"]
        self.static = static

    def prove(self, fresh: dict, prover_seed: int):
        tables = {**self.static, **fresh}
        unused = {f.name: tables.get(f.name, torch.zeros((1, 0, 16), dtype=torch.int32,
                                                          device=self.curve.device))
                  for f in dataclasses.fields(PackedProvingParameters)
                  if f.name not in ("n", "pp", "curve", "c_commitment", "d_commitment")}
        pk = PackedProvingParameters(n=self.n, pp=self.pp, curve=self.curve,
                                     c_commitment=self.srs_c, d_commitment=self.srs_d, **unused)
        net = PartyNet(self.N, "leader")
        bundle = collaborative.dhyperplonk(self.n, pk, net, seed=prover_seed)
        up, down = net.comm(0)
        return bundle, (up, down, net.rounds)

    def close(self):
        self.srs_c = self.srs_d = self.static = None
