"""Prover inputs: PackedProvingParameters and their seeded generators.

Mirrors the JAX package's ``hyperplonk/params.py`` (parity:
dhyperplonk.rs:21-157).  As in the reference, every input is a seeded
random placeholder of the right size ("Jump from sky", dhyperplonk.rs:
187-190): arithmetic and communication are cost-faithful, the witness is
not a real circuit.  Fields with a ``_p`` suffix are plain values sliced
1/N per party; the rest are PSS shares sized 1/l per party.  Every
per-party vector is a tensor [P, len, L] (P = N in ``sim`` mode, 1 in
``leader`` mode, N / W on each of W processes of a net spread over a
process group, which draws the rows of its parties, cut on the host:
``PartyNet.random_rows``); challenges are [k, L] or [L].  The inputs are
drawn with the JAX package's ``RandomState`` seeds, so both packages make
the same bits.

``SCZK_SRS_CACHE=<dir>`` keeps the seeded random SRS of
``benchmark_srs`` on disk between processes (the JAX package's opt-in
cache): the first ``packed_proving_parameters`` call for (curve, n, N, l,
seed) writes it, later ones load it onto their device.  Its contract is
the seeded points alone, so a loaded SRS is the built one bit for bit.
An honest SRS or one passed as ``srs=`` is never cached, but
``save_srs_cache``/``load_srs_cache`` move any SRS pair through a file
(the split prove hands the honest one to its ranks so).  The files are
the port's own (``srs_torch_v1_...``); it reads no file of the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..curves.g1 import Curve, PointJ, bls12_381_g1
from ..device import DEFAULT
from ..mpc.net import PartyNet
from ..primitives.mle import fix_variable, pack_vec
from ..primitives.poly_comm import PolynomialCommitment, party_packed_levels, srs_random
from ..pss.pss import PackedSharingParams


@dataclasses.dataclass
class PackedProvingParameters:
    """All collaborative-prover inputs (dhyperplonk.rs:21-62)."""

    n: int
    pp: PackedSharingParams
    curve: Curve
    # witness shares (gate_count * 4 / l per party)
    V: torch.Tensor
    a_evals: torch.Tensor
    b_evals: torch.Tensor
    c_evals: torch.Tensor
    # input / selectors: shares and plain slices
    I: torch.Tensor  # noqa: E741
    S1: torch.Tensor
    S2: torch.Tensor
    I_p: torch.Tensor
    S1_p: torch.Tensor
    S2_p: torch.Tensor
    # permutation / identity polynomials
    ssigma: torch.Tensor
    ssigma_p: torch.Tensor
    ssigma_a: torch.Tensor
    ssigma_b: torch.Tensor
    ssigma_c: torch.Tensor
    sid: torch.Tensor
    sid_p: torch.Tensor
    # eq polynomials
    eq: torch.Tensor
    eq_top_p: torch.Tensor
    eq_r1: torch.Tensor
    eq_r1_p: torch.Tensor
    eq_r2: torch.Tensor
    eq_r2_p: torch.Tensor
    # challenges
    challenge: torch.Tensor
    challenge_r1: torch.Tensor
    challenge_r2: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    # commitments (SRS)
    d_commitment: PolynomialCommitment
    c_commitment: PolynomialCommitment
    # masks for c_acc_product_and_share
    mask: torch.Tensor
    unmask0: torch.Tensor
    unmask1: torch.Tensor
    unmask2: torch.Tensor
    # dummies
    reduce_target: torch.Tensor


PARTY_FIELDS = ("V", "a_evals", "b_evals", "c_evals", "I", "S1", "S2", "I_p", "S1_p", "S2_p",
                "ssigma", "ssigma_p", "ssigma_a", "ssigma_b", "ssigma_c", "sid", "sid_p", "eq",
                "eq_top_p", "eq_r1", "eq_r1_p", "eq_r2", "eq_r2_p", "mask", "unmask0", "unmask1",
                "unmask2", "reduce_target")
"""The fields of ``PackedProvingParameters`` with a party axis first, by
name: a process holding parties [o, o + P) keeps rows [o, o + P) of each.
(The challenges' leading axes are not party axes, though at some sizes
they are as long.)"""


def _corner_points(F):
    """The (x0, x1) points (0, 0), (0, 1), (1, 0) that pick a, b and c out of V."""
    zero, one = F.const(0), F.const(1)
    return torch.stack([zero, zero]), torch.stack([zero, one]), torch.stack([one, zero])


def consistent_proving_parameters(n: int, l: int, net: PartyNet, srs: dict,
                                  curve: Optional[Curve] = None, seed: int = 1,
                                  device=DEFAULT):
    """Inputs that are consistent shares and slices of one global witness,
    so distributed transcripts can be opened and checked against the
    monolithic oracle.  Needs ``sim`` mode and an honest ``srs`` =
    {"c": packed secret-derived SRS, "d": secret-derived SRS with the
    distributed extension}.  Returns (pk, global polynomials by name)."""
    if net.mode != "sim":
        raise ValueError("consistent proving parameters need sim mode")
    curve = bls12_381_g1(device) if curve is None else curve
    F = curve.fr
    pp = PackedSharingParams(F, l)
    N = pp.n
    gc = 1 << n
    rg = lambda sz, k: F.random((sz,), seed * 7013 + k)  # noqa: E731
    g = {"V": rg(gc * 4, 1), "I": rg(gc, 3), "S1": rg(gc, 4), "S2": rg(gc, 5),
         "ssigma": rg(gc * 4, 9), "sid": rg(gc * 4, 10), "eq": rg(gc, 12),
         "eq_r1": rg(gc * 4, 14), "eq_r2": rg(gc * 4, 16)}
    pts00, pts01, pts10 = _corner_points(F)
    g["a"] = fix_variable(F, g["V"], pts00)
    g["b"] = fix_variable(F, g["V"], pts01)
    g["c"] = fix_variable(F, g["V"], pts10)
    sh = lambda x: _own_rows(net, pack_vec(pp, x))  # noqa: E731
    sl = lambda x: _own_rows(net, x.reshape(N, x.shape[-2] // N, F.L))  # noqa: E731
    rnd = lambda shape, k: F.random(shape, seed * 1009 + k)  # noqa: E731
    rows = lambda tail, k: net.random_rows(F, tail, seed * 1009 + k)  # noqa: E731
    pk = PackedProvingParameters(
        n=n, pp=pp, curve=curve,
        V=sh(g["V"]), a_evals=sh(g["a"]), b_evals=sh(g["b"]), c_evals=sh(g["c"]),
        I=sh(g["I"]), S1=sh(g["S1"]), S2=sh(g["S2"]),
        I_p=sl(g["I"]), S1_p=sl(g["S1"]), S2_p=sl(g["S2"]),
        ssigma=sh(g["ssigma"]), ssigma_p=sl(g["ssigma"]),
        ssigma_a=sh(fix_variable(F, g["ssigma"], pts00)),
        ssigma_b=sh(fix_variable(F, g["ssigma"], pts01)),
        ssigma_c=sh(fix_variable(F, g["ssigma"], pts10)),
        sid=sh(g["sid"]), sid_p=sl(g["sid"]),
        eq=sh(g["eq"]), eq_top_p=rows((N * 2,), 13),
        eq_r1=sh(g["eq_r1"]), eq_r1_p=sl(g["eq_r1"]),
        eq_r2=sh(g["eq_r2"]), eq_r2_p=sl(g["eq_r2"]),
        challenge=rnd((n,), 18), challenge_r1=rnd((n + 2,), 19), challenge_r2=rnd((n + 2,), 20),
        alpha=rnd((), 21), beta=rnd((), 22), gamma=rnd((), 23),
        d_commitment=srs["d"], c_commitment=srs["c"],
        mask=rows((gc * 4 // l,), 24), unmask0=rows((gc * 4 // l,), 25),
        unmask1=rows((gc * 4 // l,), 26), unmask2=rows((gc * 4 // l,), 27),
        reduce_target=rows((max(gc // l // l, 1),), 28),
    )
    return pk, g


def _own_rows(net: PartyNet, table: torch.Tensor) -> torch.Tensor:
    """The net's rows of a per-party table [N, ...]; a copy when the
    parties are spread over processes, so the whole table is freed."""
    rows = net.party_rows(table)
    return rows if net.group is None else rows.clone()


def benchmark_srs(curve: Curve, n: int, pp: PackedSharingParams, seed: int = 1) -> dict:
    """The prove's random SRS pair: "c", ``new_single`` (packed levels,
    identical across parties, dpoly_comm.rs:197-219); "d", ``new_random``
    with root levels for d_open, its levels capped at
    max(n + 2 - log2 N, log2 N) (dpoly_comm.rs:222; the floor keeps the
    leader tree-top's commit at level log2 N inside the SRS at small n,
    one of the JAX package's documented deviations)."""
    s_bits = pp.n.bit_length() - 1
    return {"c": srs_random(curve, n + 2, seed + 17, packed_parties=pp.n, max_level=-1),
            "d": srs_random(curve, n + 2, seed + 23, n_parties=pp.n,
                            max_level=max(n + 2 - s_bits, s_bits))}


SRS_CACHE_VERSION = "srs_torch_v1"
"""Leads every cache file's name; a change of layout changes it."""

_SRS_POINT_LISTS = ("powers_of_g", "root_levels", "packed_powers")


def srs_cache_path(curve: Curve, n: int, pp: PackedSharingParams, seed: int,
                   cache_dir=None) -> Optional[Path]:
    """The cache file of ``benchmark_srs(curve, n, pp, seed)`` under
    ``cache_dir``, by default ``SCZK_SRS_CACHE``; None when neither is set."""
    root = cache_dir or os.environ.get("SCZK_SRS_CACHE")
    if not root:
        return None
    return Path(root) / f"{SRS_CACHE_VERSION}_{curve.name}_n{n}_N{pp.n}_l{pp.l}_s{seed}.pkl"


def map_levels(levels, fn):
    """``fn`` on each point of a list of levels, or of a dict of such lists
    (an honest SRS's root levels, keyed by variable count)."""
    if levels is None:
        return None
    if isinstance(levels, dict):
        return {k: [fn(pt) for pt in v] for k, v in levels.items()}
    return [fn(pt) for pt in levels]


def srs_to_host(pc: PolynomialCommitment) -> dict:
    """An SRS's host fields: its fields without its curve, every point as
    numpy int32 limbs."""
    out = {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc) if f.name != "curve"}
    for key in _SRS_POINT_LISTS:
        out[key] = map_levels(out[key], lambda pt: tuple(a.cpu().numpy() for a in pt))
    return out


def shard_srs(fields: dict, net: Optional[PartyNet]) -> dict:
    """An SRS's host fields with its per-party packed levels cut to the
    net's rows before their upload (``party_packed_levels``), and
    ``packed_offset`` the net's first party; as they are without a group."""
    if net is None or net.group is None or fields["packed_powers"] is None:
        return fields
    return dict(fields, packed_powers=party_packed_levels(fields["packed_powers"], net),
                packed_offset=net.party_offset)


def srs_from_host(curve: Curve, fields: dict) -> PolynomialCommitment:
    """The inverse of ``srs_to_host``: the SRS on ``curve``'s device."""
    fields = dict(fields)
    for key in _SRS_POINT_LISTS:
        fields[key] = map_levels(fields[key], lambda pt: PointJ(*(
            torch.from_numpy(np.ascontiguousarray(a)).to(curve.device) for a in pt)))
    return PolynomialCommitment(curve=curve, **fields)


def load_srs_cache(path: Path, curve: Curve, net: Optional[PartyNet] = None) -> Optional[dict]:
    """{"c": ..., "d": ...} from a cache file onto ``curve``'s device, or
    None when the file is missing or cannot be read whole (it is then
    rebuilt and written again).  With a ``net`` spread over processes, a
    per-party packed level keeps the net's rows (``shard_srs``)."""
    try:
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        return {k: srs_from_host(curve, shard_srs(blob[k], net)) for k in ("c", "d")}
    except FileNotFoundError:
        return None
    except (OSError, EOFError, pickle.UnpicklingError, KeyError, TypeError, ValueError) as exc:
        warnings.warn(f"SRS cache {path} unreadable ({type(exc).__name__}: {exc}); rebuilding it")
        return None


def save_srs_cache(path: Path, srs: dict):
    """Write ``srs`` as host numpy arrays: to a temporary file, then renamed
    over ``path``, so a reader never sees half a file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as fh:
            pickle.dump({k: srs_to_host(srs[k]) for k in ("c", "d")}, fh, protocol=4)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def cached_benchmark_srs(curve: Curve, n: int, pp: PackedSharingParams, seed: int = 1,
                         cache_dir=None) -> dict:
    """``benchmark_srs``, through the cache directory (``cache_dir``, by
    default ``SCZK_SRS_CACHE``) when there is one: loaded when its file
    reads whole, else built and written."""
    path = srs_cache_path(curve, n, pp, seed, cache_dir)
    srs = None if path is None else load_srs_cache(path, curve)
    if srs is None:
        srs = benchmark_srs(curve, n, pp, seed)
        if path is not None:
            save_srs_cache(path, srs)
    return srs


def packed_proving_parameters(n: int, l: int, net: PartyNet, curve: Optional[Curve] = None,
                              seed: int = 1, srs: Optional[dict] = None,
                              device=DEFAULT) -> PackedProvingParameters:
    """All inputs (dhyperplonk.rs:64-157) for N = 8l parties, on ``device``
    (default CUDA; raises without a card).  ``srs``: an optional
    {"c": ..., "d": ...} in place of ``benchmark_srs`` (which
    ``SCZK_SRS_CACHE`` keeps on disk, ``cached_benchmark_srs``)."""
    curve = bls12_381_g1(device) if curve is None else curve
    F = curve.fr
    pp = PackedSharingParams(F, l)
    if net.n != pp.n:
        raise ValueError(f"a net of {net.n} parties for l = {l} (N = {pp.n})")
    gc = 1 << n
    r = lambda shape, k: F.random(shape, seed * 1009 + k)  # noqa: E731
    rows = lambda tail, k: net.random_rows(F, tail, seed * 1009 + k)  # noqa: E731
    pts00, pts01, pts10 = _corner_points(F)
    V = rows((gc * 4 // l,), 1)
    ssigma = rows((gc * 4 // l,), 2)
    srs = cached_benchmark_srs(curve, n, pp, seed) if srs is None else srs
    return PackedProvingParameters(
        n=n, pp=pp, curve=curve,
        V=V,
        a_evals=fix_variable(F, V, pts00),
        b_evals=fix_variable(F, V, pts01),
        c_evals=fix_variable(F, V, pts10),
        I=rows((gc // l,), 3), S1=rows((gc // l,), 4), S2=rows((gc // l,), 5),
        I_p=rows((gc // pp.n,), 6), S1_p=rows((gc // pp.n,), 7), S2_p=rows((gc // pp.n,), 8),
        ssigma=ssigma,
        ssigma_p=rows((gc * 4 // pp.n,), 9),
        ssigma_a=fix_variable(F, ssigma, pts00),
        ssigma_b=fix_variable(F, ssigma, pts01),
        ssigma_c=fix_variable(F, ssigma, pts10),
        sid=rows((gc * 4 // l,), 10), sid_p=rows((gc * 4 // pp.n,), 11),
        eq=rows((gc // l,), 12), eq_top_p=rows((pp.n * 2,), 13),
        eq_r1=rows((gc * 4 // l,), 14), eq_r1_p=rows((gc * 4 // pp.n,), 15),
        eq_r2=rows((gc * 4 // l,), 16), eq_r2_p=rows((gc * 4 // pp.n,), 17),
        challenge=r((n,), 18), challenge_r1=r((n + 2,), 19), challenge_r2=r((n + 2,), 20),
        alpha=r((), 21), beta=r((), 22), gamma=r((), 23),
        d_commitment=srs["d"], c_commitment=srs["c"],
        mask=rows((gc * 4 // l,), 24), unmask0=rows((gc * 4 // l,), 25),
        unmask1=rows((gc * 4 // l,), 26), unmask2=rows((gc * 4 // l,), 27),
        reduce_target=rows((max(gc // l // l, 1),), 28),
    )
