"""The port's tools: the benchmark-SRS disk cache, the bench entry's new
flags, the measurement scripts and the examples, on the CPU at small
sizes, against the JAX package where it writes the same thing.

Every entry takes ``--device`` (``device=``), defaults to the card and
raises without one; these tests pass ``cpu``.
"""

import csv
import functools
import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from scalable_collaborative_zksnark_tpu_torch import bench
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.examples import delegator, msm as msm_example
from scalable_collaborative_zksnark_tpu_torch.examples import poly_comm, prod_acc
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import params
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives.mle import unpack_vec
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.scripts import (g1_micro, pin_digest, pregen_srs,
                                                               profile_primitives, sweep)

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--l", "1", "--n", "4", "--mode", "leader", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A cache directory holding the (4, 1) benchmark SRS, built once here:
    (directory, curve, pp, the built SRS)."""
    root = tmp_path_factory.mktemp("srs_cache")
    curve = bls12_381_g1("cpu")
    pp = PackedSharingParams(curve.fr, 1)
    built = params.cached_benchmark_srs(curve, 4, pp, 1, root)
    return root, curve, pp, built


def _same_srs(a, b) -> bool:
    for key in ("powers_of_g", "root_levels", "packed_powers"):
        la, lb = getattr(a, key), getattr(b, key)
        if (la is None) != (lb is None):
            return False
        for pa, pb in zip(la or [], lb or []):
            if not all(torch.equal(x, y) for x, y in zip(pa, pb)):
                return False
    wa, wb = a.party_weights, b.party_weights
    return (a.powers_of_g2 == b.powers_of_g2 and a.affine == b.affine
            and (wa is None) == (wb is None) and (wa is None or list(wa) == list(wb)))


def test_srs_cache_round_trip(cache, monkeypatch):
    """The file holds the (4, 1) SRS under its versioned name; a load gives
    the built tensors back; ``packed_proving_parameters`` with
    ``SCZK_SRS_CACHE`` loads it and builds nothing; an explicit ``srs=``
    writes no file; a truncated file is rebuilt and written again whole."""
    root, curve, pp, built = cache
    path = params.srs_cache_path(curve, 4, pp, 1, root)
    assert path.name == "srs_torch_v1_bls12_381_g1_n4_N8_l1_s1.pkl" and path.exists()
    loaded = params.load_srs_cache(path, curve)
    assert all(_same_srs(built[k], loaded[k]) for k in ("c", "d"))
    assert loaded["d"].powers_of_g[2].x.device.type == "cpu"

    def no_build(*args):
        raise AssertionError("the SRS was built, not loaded")
    monkeypatch.setattr(params, "benchmark_srs", no_build)
    monkeypatch.setenv("SCZK_SRS_CACHE", str(root))
    pk = params.packed_proving_parameters(4, 1, PartyNet(8, "leader"), curve=curve)
    assert _same_srs(pk.d_commitment, built["d"]) and _same_srs(pk.c_commitment, built["c"])

    other = root / "explicit"
    monkeypatch.setenv("SCZK_SRS_CACHE", str(other))
    params.packed_proving_parameters(4, 1, PartyNet(8, "leader"), curve=curve, srs=built)
    assert not other.exists()

    size = path.stat().st_size
    path.write_bytes(path.read_bytes()[: size // 2])
    builds = []
    monkeypatch.setattr(params, "benchmark_srs", lambda *a: builds.append(a) or built)
    with pytest.warns(UserWarning, match="unreadable"):
        again = params.cached_benchmark_srs(curve, 4, pp, 1, root)
    assert len(builds) == 1 and again is built and path.stat().st_size == size
    assert _same_srs(params.load_srs_cache(path, curve)["d"], built["d"])
    assert params.srs_cache_path(curve, 4, pp, 1) is not None  # SCZK_SRS_CACHE is set
    monkeypatch.delenv("SCZK_SRS_CACHE")
    assert params.srs_cache_path(curve, 4, pp, 1) is None


def test_pregen_and_profile_primitives_use_the_cache(cache, monkeypatch, capsys):
    """``pregen_srs`` finds the (4, 1) file already there; ``profile_primitives``
    set up from the cache times the steps it is asked for."""
    root, *_ = cache
    out = pregen_srs.run(4, 1, "cpu", cache_dir=root)
    assert out["was_cached"] and out["bytes"] > 0 and Path(out["path"]).parent == root
    monkeypatch.setenv("SCZK_SRS_CACHE", str(root))
    rows = profile_primitives.run(4, 1, "cpu", only=["c_sumcheck_sV", "d_acc_product"])
    assert [r["step"] for r in rows] == ["c_sumcheck_sV", "d_acc_product"]
    assert all(r["warm_ms"] > 0 for r in rows)
    assert "c_sumcheck_sV" in capsys.readouterr().out


@pytest.mark.parametrize("example, argv, expect", [
    pytest.param(msm_example, TINY, ("d_msm n=4 l=1 (16 pts/party)", "comm up=392 down=392",
                                     "local msm"), marks=pytest.mark.slow),
    pytest.param(poly_comm, TINY, ("c_commit n=4 l=1", "c_open   n=4 l=1"),
                 marks=pytest.mark.slow),
    (prod_acc, ["--l", "1", "--n", "5", "--mode", "leader", "--device", "cpu"],
     ("c_acc_product_and_share n=5 l=1", "streams [32, 32, 32]")),
    (delegator, TINY, ("wrote 8 share files", "read-back reconstruction: OK")),
], ids=["msm", "poly_comm", "prod_acc", "delegator"])
def test_example(example, argv, expect, tmp_path, capsys):
    """Each example at the sizes tests/test_examples.py runs the JAX
    package's at, on the CPU (``msm`` and ``poly_comm`` run CPU ladders for
    seconds, so they are slow cases)."""
    if example is delegator:
        argv = argv + ["--out", str(tmp_path)]
    example.main(argv)
    out = capsys.readouterr().out
    assert all(e in out for e in expect), out


def _run_jax_example(module, argv):
    sys.path.insert(0, str(ROOT))
    try:
        mod = importlib.import_module(f"examples.{module}")
        old, sys.argv = sys.argv, [module] + argv
        try:
            mod.main()
        finally:
            sys.argv = old
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("l", [1, pytest.param(2, marks=pytest.mark.slow)])
def test_delegator_files_match_jax(tmp_path, capsys, l):
    """The port's share files and manifest are byte-equal to the JAX
    example's for the same seed, and each package's files reconstruct the
    witness when the other's reader loads them."""
    argv = ["--l", str(l), "--n", "4"]
    _run_jax_example("delegator", argv + ["--out", str(tmp_path / "jax")])
    delegator.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jax_files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(jax_files) == 8 * l + 1
    for name in jax_files:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    F = get_field("bls12_381_fr", device="cpu")
    pp = PackedSharingParams(F, l)
    assert torch.equal(unpack_vec(pp, delegator.read_shares(tmp_path / "jax", "cpu")),
                       F.random((16,), 42))
    assert capsys.readouterr().out.count("read-back reconstruction: OK") == 2


@pytest.mark.parametrize("suite, mode", [
    pytest.param("pss", "leader", marks=pytest.mark.slow), ("sumcheck", "sim")])
def test_sweep_csv(tmp_path, suite, mode):
    """``sweep`` writes one row a cell with the JAX script's columns (the
    ``pss`` suite's G1 ladders take seconds on the CPU: a slow case)."""
    out = tmp_path / "sweep.csv"
    ls = ["1"] if suite == "pss" else ["1", "2"]
    sweep.main(["--suite", suite, "--n", "4", "--l", *ls, "--mode", mode, "--device", "cpu",
                "--out", str(out)])
    with open(out, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert tuple(rows[0]) == sweep.COLUMNS == (
        "suite", "n", "l", "mode", "backend", "seconds", "up_bytes", "down_bytes")
    assert [(r["suite"], r["n"], r["l"], r["mode"], r["backend"]) for r in rows] == [
        (suite, "4", l, mode, "cpu") for l in ls]
    assert all(float(r["seconds"]) > 0 for r in rows)
    if suite == "sumcheck":  # sim mode: every party's bytes counted
        assert all(int(r["up_bytes"]) > 0 and int(r["down_bytes"]) > 0 for r in rows)


def test_bench_flags_parse():
    """``--smoke`` is n = 4, l = 1 on the requested device (the card by
    default); ``--trace DIR`` and ``--conformance`` parse."""
    a = bench.parse_args(["--smoke"])
    assert (a.n, a.l, a.device, a.trace, a.conformance) == (4, 1, "cuda", None, False)
    a = bench.parse_args(["--smoke", "--device", "cpu", "--trace", "out", "--repeat", "1"])
    assert (a.n, a.l, a.device, a.trace, a.repeat) == (4, 1, "cpu", "out", 1)
    a = bench.parse_args(["--conformance", "--n", "16"])
    assert a.conformance and a.n == 16
    assert [k for k in bench.PINS if k[0] <= bench.CONFORMANCE_PROVE_MAX_N] == [(6, 1)]


def test_bench_report_trace_and_conformance(tmp_path, monkeypatch, capsys):
    """The bench entry's JSON line with ``--trace`` (the profile written) and
    ``--conformance``'s PASS and FAIL lines, on stand-ins for the set-up and
    the prove (the whole prove on the CPU is the slow test below)."""
    curve = bls12_381_g1("cpu")
    monkeypatch.setattr(bench, "packed_proving_parameters",
                        lambda n, l, net, device=None: SimpleNamespace(curve=curve))
    monkeypatch.setattr(bench, "dhyperplonk", lambda n, pk, net: torch.ones(4).sum())
    digest = bench.PINS[(6, 1)]
    monkeypatch.setattr(bench, "proof_digest", lambda c, bundle: digest)
    assert bench.main(["--n", "6", "--l", "1", "--device", "cpu", "--repeat", "2",
                       "--trace", str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["conformance"] == "pass" and len(report["runs"]) == 2
    assert report["metric"] == "dhyperplonk_per_party_prove_s_n6_l1_cpu"
    assert json.loads(Path(report["trace"]).read_text())["traceEvents"]
    assert bench.main(["--conformance", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["verdict"] == "PASS" and line["results"]["n6_l1"]["pass"]
    digest += 1
    assert bench.main(["--conformance", "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out)["verdict"] == "FAIL"


@pytest.mark.parametrize("entry, argv", [
    (bench.main, ["--smoke"]), (bench.main, ["--conformance"]),
    (bench.main, ["--trace", "x", "--n", "4", "--l", "1"]),
    (pin_digest.main, ["--n", "4", "--l", "1"]), (sweep.main, ["--n", "4"]),
    (profile_primitives.main, ["--n", "4", "--l", "1"]), (g1_micro.main, []),
    (pregen_srs.main, ["--n", "4", "--l", "1"]), (msm_example.main, []), (poly_comm.main, []),
    (prod_acc.main, []), (delegator.main, [])],
    ids=["bench-smoke", "bench-conformance", "bench-trace", "pin_digest", "sweep",
         "profile_primitives", "g1_micro", "pregen_srs", "msm", "poly_comm", "prod_acc",
         "delegator"])
def test_new_entries_default_to_cuda(no_cuda, entry, argv, tmp_path, monkeypatch):
    """No entry, script or flag of this slice falls back to the CPU: each
    asks for the card unless told ``--device cpu``, and raises without one
    before it writes anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SCZK_SRS_CACHE", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="cuda"):
        entry(argv)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.slow
def test_bench_smoke_trace_and_conformance_on_cpu(tmp_path, capsys):
    """The whole bench entry on the CPU: ``--smoke`` with ``--trace`` (the
    trace written, the (4, 1) digest the JAX package's, recomputed here),
    and ``--conformance`` proving (6, 1) to its pin (minutes)."""
    assert bench.main(["--smoke", "--device", "cpu", "--repeat", "1",
                       "--trace", str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert Path(report["trace"]).stat().st_size > 0
    assert report["metric"] == "dhyperplonk_per_party_prove_s_n4_l1_cpu"
    assert report["digest"] == f"0x{_jax_digest(4, 1):016x}"
    assert bench.main(["--conformance", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["verdict"] == "PASS" and line["results"]["n6_l1"]["pass"]


@functools.lru_cache(maxsize=None)
def _jax_digest(n, l):
    from scalable_collaborative_zksnark_tpu.hyperplonk import (dhyperplonk as jdh,
                                                               packed_proving_parameters as jppp)
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
    from scalable_collaborative_zksnark_tpu.utils.benchlib import proof_digest
    net = JaxNet(8 * l, mode="leader")
    return proof_digest(jdh(n, jppp(n, l, net), net))


@pytest.mark.slow
def test_pin_digest_and_g1_micro_on_cpu(cache, monkeypatch, capsys):
    """``pin_digest`` at (4, 1) prints the JAX package's digest; ``g1_micro``
    runs every row at tiny sizes (minutes on the CPU)."""
    root, *_ = cache
    monkeypatch.setenv("SCZK_SRS_CACHE", str(root))
    assert pin_digest.main(["--n", "4", "--l", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"(4, 1): 0x{_jax_digest(4, 1):016X}"
    rows = g1_micro.run("cpu", reps=1, lanes=8, steps=4, ladder=(4,), horner=((4, 2, 2),))
    assert len(rows) == 5 and all(r["warm_ms"] > 0 for r in rows)


def test_chip_smoke_replay_helpers(monkeypatch):
    """``chip_smoke.replay`` holds Horner on host copies of its operands and
    still catches a difference; ``_ReplayEachLayout`` replays no G1 call
    outside a c-side commit or open but the ladder's, and inside one the
    first call at each layout; ``_captured`` returns a script's exit code
    and output."""
    import chip_smoke
    from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
    from scalable_collaborative_zksnark_tpu_torch.curves.g1 import map_points
    from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import rand_points_flat
    curve = bls12_381_g1("cpu")
    spec = curve.fq.spec
    tot = map_points(lambda a: a.reshape(3, 2, -1), rand_points_flat(curve, 6, 5))
    out = cuda_g1.horner(spec, tot, 2)
    assert chip_smoke.replay([("g1_horner", (spec, tot, 2), out)])[0] == {"g1_horner": 1}
    with pytest.raises(AssertionError, match="g1_horner"):
        chip_smoke.replay([("g1_horner", (spec, tot, 2), (out[0] + 1, out[1], out[2]))])
    keep = chip_smoke._ReplayEachLayout()
    keep([], ("g1_horner", (spec, tot, 2), (out[0] + 1, out[1], out[2])))
    assert keep.seen == {}
    keep.c_side = 1
    keep([], ("g1_horner", (spec, tot, 2), out))
    keep([], ("g1_horner", (spec, tot, 2), (out[0] + 1, out[1], out[2])))  # layout seen
    assert keep.seen == {"g1_horner": 1}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rc, text, _ = chip_smoke._captured(
        sweep.main, ["--suite", "sumcheck", "--n", "3", "--l", "1", "--device", "cpu"])
    assert rc == 0 and "'suite': 'sumcheck'" in text
