"""Shared command-line plumbing of the port's example and benchmark entries.

Mirrors the JAX package's ``examples/common.py`` (the reference's clap
``--l --n`` flags and execution modes):

* ``--mode sim``: all N parties computed, their party axis a batch axis;
* ``--mode leader``: one party computed, every party's bytes counted;
* ``--device``: ``cuda`` (the default; raises where there is no card) or
  ``cpu``, where every kernel wrapper runs its plain version.  It takes
  the place of the JAX package's ``--cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import DEFAULT, resolve, sync
from ..utils import timer


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--l", type=int, default=2, help="packing factor (N = 8l)")
    ap.add_argument("--n", type=int, default=8, help="log2 problem size")
    ap.add_argument("--mode", choices=("sim", "leader"), default="leader")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--trace", action="store_true", help="print timer trace")
    return ap


def setup(args) -> torch.device:
    """Resolve ``--device`` (raising where CUDA is asked for and absent) and
    turn the port's span timer on or off by ``--trace``."""
    dev = resolve(args.device)
    timer.enable(args.trace)
    return dev


def timed(fn, device: torch.device):
    """(result, seconds) of one run of ``fn``, waiting for the card."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def warm_up(fn, device: torch.device):
    """One untimed run of ``fn`` on the card, where a first call loads the
    kernels and makes their first launches; none on the CPU, whose plain
    versions load nothing."""
    if device.type == "cuda":
        fn()
        sync(device)
