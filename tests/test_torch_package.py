"""The port as a package: no JAX, explicit devices, no silent fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu_torch import bench, convert, cuda_build
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves import g1 as g1_module
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1, map_points
from scalable_collaborative_zksnark_tpu_torch.examples import bench_micro, common
from scalable_collaborative_zksnark_tpu_torch.examples import hyperplonk as hp_example
from scalable_collaborative_zksnark_tpu_torch.examples import permcheck as pc_example
from scalable_collaborative_zksnark_tpu_torch.examples import sumcheck as example
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr, mxu
from scalable_collaborative_zksnark_tpu_torch.fields import fr as fr_module
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import mxu_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck as sumcheck_module
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import sharding
from scalable_collaborative_zksnark_tpu_torch.scripts import (chain_bench, exp_fieldmul,
                                                               microbench, mxu_micro,
                                                               profile_phases, run_multihost)
from scalable_collaborative_zksnark_tpu_torch.utils import timer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "scalable_collaborative_zksnark_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "scalable_collaborative_zksnark_tpu")


@pytest.fixture()
def cuda():
    """The card, or a skip; decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_default_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        get_field("bls12_381_fr")
    with pytest.raises(RuntimeError, match="cuda"):
        example.main(["--n", "4", "--l", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_numpy(np.zeros((2, 16), np.uint32))
    with pytest.raises(RuntimeError, match="cuda"):
        bls12_381_g1()
    with pytest.raises(RuntimeError, match="cuda"):
        convert.points_from_numpy([np.zeros((2, 24), np.uint32)] * 3)
    with pytest.raises(RuntimeError, match="cuda"):
        packed_proving_parameters(4, 1, PartyNet(8, "leader"))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--n", "4", "--l", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run(4, 1)
    for entry in (exp_fieldmul.main, mxu_micro.main, microbench.main, bench_micro.main,
                  chain_bench.main):
        with pytest.raises(RuntimeError, match="cuda"):
            entry([])
    for run in (exp_fieldmul.run, mxu_micro.run, microbench.run, chain_bench.run):
        with pytest.raises(RuntimeError, match="cuda"):
            run()
    with pytest.raises(RuntimeError, match="cuda"):
        common.setup(common.base_parser("x").parse_args([]))
    assert common.setup(common.base_parser("x").parse_args(["--device", "cpu"])).type == "cpu"
    assert get_field("bls12_381_fr", device="cpu").device.type == "cpu"
    assert bls12_381_g1("cpu").device.type == "cpu"
    assert convert.from_numpy(np.zeros((2, 16), np.uint32), "cpu").device.type == "cpu"


def test_split_entry_points_default_to_cuda(no_cuda):
    """The split prove's entry points ask for the card unless told
    otherwise, and raise without one; NCCL without a card raises."""
    with pytest.raises(RuntimeError, match="cuda"):
        run_multihost.main(["--n", "4", "--l", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        profile_phases.main(["--n", "4", "--l", "1"])
    for backend in ("gloo", "nccl"):
        with pytest.raises(RuntimeError, match="cuda|CUDA"):
            sharding.init_party_group(backend, 2, 0, "file:///nonexistent")


def test_run_multihost_needs_an_init_method(capsys):
    """A process of a world of several names its rendezvous: no fixed
    port is assumed."""
    with pytest.raises(SystemExit) as exc:
        run_multihost.main(["--world-size", "2", "--rank", "1", "--backend", "gloo"])
    assert exc.value.code == 2
    assert "--init-method" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--variant", "local", "--n", "2"], ["--variant", "dist", "--n", "4", "--l", "1"],
    ["--variant", "dist", "--n", "4", "--l", "1", "--mode", "sim", "--verify"]])
def test_hyperplonk_example_defaults_to_cuda(no_cuda, argv):
    with pytest.raises(RuntimeError, match="cuda"):
        hp_example.main(argv)


@pytest.mark.parametrize("variant", ["c", "d"])
def test_permcheck_example_defaults_to_cuda(no_cuda, variant):
    with pytest.raises(RuntimeError, match="cuda"):
        pc_example.main(["--variant", variant, "--n", "4", "--l", "1"])


def test_chip_smoke_refuses_without_card(no_cuda, capsys):
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_cpu_calls_launch_nothing():
    """On the CPU the wrappers run their plain versions and count nothing."""
    F = get_field("bls12_381_fr", device="cpu")
    before = (cuda_fr.mul.launches, cuda_fr.add.launches, cuda_fr.sub.launches,
              cuda_sumcheck.product_phase.launches)
    f, g, ch = F.random((2, 8), 1), F.random((2, 8), 2), F.random((4,), 3)
    cuda_sumcheck.product_phase(F, f, g, ch, 0)
    F.sub(F.add(f, g), F.mul(f, g))
    strided = cuda_fr.mul_limb_major.launches, cuda_fr.mul_tiled.launches
    x = F.random((4096,), 4)
    cuda_fr.mul_limb_major(F.spec, exp_fieldmul.to_limb_major(x), exp_fieldmul.to_limb_major(x))
    cuda_fr.mul_tiled(F.spec, exp_fieldmul.to_tiled(x), exp_fieldmul.to_tiled(x))
    assert before == (cuda_fr.mul.launches, cuda_fr.add.launches, cuda_fr.sub.launches,
                      cuda_sumcheck.product_phase.launches)
    assert strided == (cuda_fr.mul_limb_major.launches, cuda_fr.mul_tiled.launches)


def test_mxu_matmuls_count(monkeypatch):
    """``mxu.matmuls`` counts one per int8 product: a dot_red over a batch of
    three tables makes three and its fold one more, mul_shared one; a whole
    phase makes some, and the default path none."""
    F = get_field("bls12_381_fr", device="cpu")
    f, g = F.random((3, 8), 1), F.random((3, 8), 2)
    monkeypatch.setattr(mxu, "matmuls", 0)
    mxu.dot_red(F.spec, mxu.to_red(f), mxu.to_red(g))
    assert mxu.matmuls == 4
    red = mxu.to_red(f)
    m_r, _ = mxu.fold_matrix(F.spec, F, g[0, 0], red.bound, red.W)
    mxu.mul_shared(F.spec, red, m_r)
    assert mxu.matmuls == 5
    ch = F.random((3,), 3)
    monkeypatch.setattr(mxu, "matmuls", 0)
    sumcheck_module._rounds_product(F, f, g, ch, 0, 3)
    assert mxu.matmuls == 0
    monkeypatch.setenv("SCZK_MXU", "1")
    msgs, _, _ = sumcheck_module._rounds_product(F, f, g, ch, 0, 3)
    assert mxu_sumcheck.available() and len(msgs) == 3 and mxu.matmuls > 3 * 3 * 3


def _g1_launches():
    return tuple(getattr(cuda_g1, n).launches for n in chip_smoke.G1_WRAPPERS)


def test_cpu_g1_calls_launch_nothing():
    """The G1 wrappers on CPU tensors run their plain versions and count nothing."""
    C = bls12_381_g1("cpu")
    spec = C.fq.spec
    before = _g1_launches(), cuda_g1.accumulate.repaired
    P = C.double(C.from_affine_ints([None, None]))
    C.add(P, P)
    C.add_mixed(P, P)
    C.scalar_mul(P, torch.zeros((2, 1), dtype=torch.int32))
    grid = PointJ(*(a.reshape(2, 1, -1) for a in P))
    cuda_g1.horner(spec, grid, 1)
    cuda_g1.bucket_serial(spec, grid)
    keys = torch.zeros(2, dtype=torch.int64)
    cuda_g1.accumulate(spec, keys, keys, keys.bool(), P, 1, 2)
    C.add_mixed_masked(P, P, torch.tensor([True, False]))
    C.add_mixed_reset(P, P, torch.tensor([False, True]))
    assert (_g1_launches(), cuda_g1.accumulate.repaired) == before


def test_cios_depth_small_cases():
    """The chain bound's depth of one CIOS product: one word is a * b, m,
    m * p (3); a second word's row waits for the first row's reduction
    before its own four steps (8)."""
    assert [chip_smoke.cios_depth(n) for n in (1, 2)] == [3, 8]


def test_chip_smoke_replays_main_path_calls():
    """chip_smoke.py's record-and-replay of the main path's kernel calls,
    run on the CPU at a small gate-identity shape."""
    F = get_field("bls12_381_fr", device="cpu")
    _, _, run = chip_smoke.gate_identity(F, dict(chip_smoke.GATE, n=6, l=2))
    with chip_smoke.recording() as calls:
        run()
    assert (fr_module.cuda_fr, sumcheck_module.cuda_sumcheck) == (cuda_fr, cuda_sumcheck)
    replayed, errs = chip_smoke.replay(calls)
    assert set(replayed) == set(errs) == set(chip_smoke.KERNELS)
    assert not any(errs.values())
    assert replayed["sumcheck_product_phase"] == 2  # phase 1 and phase 2
    # a result that differs from the plain version is caught
    name, (spec, a, b), _ = next(c for c in calls if c[0] == "fr_mul")
    with pytest.raises(AssertionError, match="fr_mul"):
        chip_smoke.replay([(name, (spec, a, b), cuda_fr.add(spec, a, b))])


def test_chip_smoke_phase_recording_keeps_calls_as_made():
    """``chip_smoke.phase_recording`` keeps each phase call's operands and
    results as they were at the call: ``sumcheck_product`` appends its
    last message to the list the phase returned, and the replay still
    pairs every message and final with the plain version's."""
    F = get_field("bls12_381_fr", device="cpu")
    f, g, ch = F.random((3, 8), 1), F.random((3, 8), 2), F.random((4,), 3)
    with chip_smoke.phase_recording() as kept:
        proof = sumcheck_module.sumcheck_product(F, f, g, ch)
    assert sumcheck_module.cuda_sumcheck is cuda_sumcheck
    assert proof.shape[-3] == 4 and len(kept) == 1 and len(kept[0][2][0]) == 3
    assert chip_smoke.replay(kept)[0] == {"sumcheck_product_phase": 1}


@pytest.mark.parametrize("case", ["broadcast", "stepped", "transposed", "misaligned"])
def test_chip_smoke_view_snapshot_keeps_layout(case):
    """``chip_smoke._view_snapshot`` keeps an operand's values, sizes,
    strides and offset from a 16-byte boundary (so its replay and timing
    take the prove's kernel instance), in memory of its own."""
    F = get_field("bls12_381_fr", device="cpu")
    base = F.random((24,), 5).contiguous()
    x = {"broadcast": base[:3, None].expand(3, 4, F.L), "stepped": base[1::5],
         "transposed": base.view(4, 6, F.L).transpose(0, 1),
         "misaligned": base.view(-1)[1:1 + 8 * F.L].view(8, F.L)}[case]
    y = chip_smoke._view_snapshot(x)
    assert y.shape == x.shape and y.stride() == x.stride() and torch.equal(y, x)
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert cuda_fr.launch_mode(y, y) == cuda_fr.launch_mode(x, x)
    base.zero_()
    assert not torch.equal(y, x)


def test_chip_smoke_records_every_elementwise_call():
    """``chip_smoke.record_elementwise`` keeps and replays every field call
    of a run (here a small gate identity on the CPU), and counts them by
    kernel instance and size; the modules are restored after it."""
    F = get_field("bls12_381_fr", device="cpu")
    _, _, run = chip_smoke.gate_identity(F, dict(chip_smoke.GATE, n=6, l=2))
    calls, keys, summary = chip_smoke.record_elementwise(run)
    assert fr_module.cuda_fr is cuda_fr and len(calls) == len(keys) > 0
    replayed = summary["elementwise_calls_replayed"]
    assert set(replayed) == {"fr_mul", "fr_add", "fr_sub"}
    assert sum(replayed.values()) == len(calls)
    assert sum(n for _, n in summary["elementwise_calls_by_mode"]) == len(calls)
    assert sum(n for _, n in summary["elementwise_calls_by_log2_outputs"]) == len(calls)
    assert {k[:2] for k in keys} == {("bls12_381_fr", op) for op in ("mul", "add", "sub")}


def test_chip_smoke_ladder_and_masked_shapes():
    """chip_smoke.py's shape keys of a ladder call (lanes after broadcast,
    scalar limbs) and of an add_masked call (lanes, masked lanes), its
    ladder bound (the cheaper of double-and-add, which short scalars take,
    and the 4-bit windows, which a full-width scalar of all ones takes) and
    its random ladder scalars."""
    C = bls12_381_g1("cpu")
    P = C.from_affine_ints([None, None, None])
    sc = torch.tensor([[1, 0], [3, 1]], dtype=torch.int32)
    assert chip_smoke._call_shape("g1_scalar_mul", (None, map_points(lambda a: a[:1], P),
                                                    sc)) == (2, 2)
    mask = torch.tensor([True, False, True])
    assert chip_smoke._call_shape("g1_add_masked", (None, P, P, mask)) == (3, 2)
    bound = chip_smoke._ladder_bound(sc, int_rate=1e30, lat_ms=1.0)
    assert bound == (32 * 3 + 2 * 5, "operations", "dependent-product chain")
    products = 2 * 32 * 7 + 2 * 16
    ops_ms = chip_smoke._ladder_bound(sc, int_rate=1e3, lat_ms=0.0)[0]
    assert ops_ms == products * chip_smoke.FQ_MULS
    ones = torch.full((1, 16), 0xFFFF, dtype=torch.int32)  # 64 non-zero windows
    assert chip_smoke._ladder_bound(ones, int_rate=1e30, lat_ms=1.0)[0] == 256 * 3 + 3 + 76 * 5
    ops_ms = chip_smoke._ladder_bound(ones, int_rate=1e3, lat_ms=0.0)[0]
    assert ops_ms == (256 * 7 + 7 + 76 * 16) * chip_smoke.FQ_MULS
    full, short = chip_smoke.ladder_scalars(C, 3, C.fr.L, 1), chip_smoke.ladder_scalars(C, 3, 2, 1)
    assert full.shape == (3, C.fr.L) and short.shape == (3, 2)
    assert all(int(v) < C.fr.p for v in C.fr.array_to_ints(C.fr.encode(full)))
    assert int(short.min()) >= 0 and int(short.max()) < 1 << 16


def test_chip_smoke_counts_device_time_once():
    """chip_smoke.py's profile sums keep only what ran on the card: a host
    op such as ``aten::index`` reports its gather kernel's device time as
    its own too, and a ``timed`` span's range on the card the time of the
    kernels in it, and counting them doubled it."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(key, device_type, us, span=False):
        return SimpleNamespace(key=key, device_type=device_type, self_device_time_total=us,
                               count=1, is_user_annotation=span)
    events = [event("aten::index", DeviceType.CPU, 7.0),
              event("Wire_identity", DeviceType.CUDA, 9.0, span=True),
              event("vectorized_gather_kernel", DeviceType.CUDA, 7.0),
              event("masked_op_team_kernel<0>", DeviceType.CUDA, 2.0),
              event("idle", DeviceType.CUDA, 0.0)]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert [e.key for e in chip_smoke._device_events(prof)] == ["vectorized_gather_kernel",
                                                               "masked_op_team_kernel<0>"]


def test_chip_smoke_per_call_device_time_needs_every_launch(monkeypatch):
    """A run's device time (``launches_a_call``) comes only from a profile
    session that reports every launch of the runs: a session that dropped
    some would read too fast, so the next one is tried, and with none
    whole the time is not measured.  A launch's time takes any session
    that reports one."""
    import contextlib
    from types import SimpleNamespace

    sessions = iter([[(8, 80.0)], [(30, 300.0), (10, 12.0)], [(5, 50.0)]])

    def session_events(prof):
        return [SimpleNamespace(key=f"phase_{k}", count=n, self_device_time_total=us)
                for k, (n, us) in enumerate(next(sessions))]
    monkeypatch.setattr(chip_smoke, "profile", lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(chip_smoke, "_device_events", session_events)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # 10 runs of 4 launches: the first session dropped 32, the second is whole
    assert chip_smoke._device_ms(lambda: None, "phase_", reps=10,
                                 launches_a_call=4) == pytest.approx(0.0312)
    sessions = iter([[(8, 80.0)], [(39, 300.0)], [(5, 50.0)]])
    assert chip_smoke._device_ms(lambda: None, "phase_", reps=10, launches_a_call=4) is None
    sessions = iter([[(8, 80.0)]])
    assert chip_smoke._device_ms(lambda: None, "phase_", reps=10) == pytest.approx(0.01)


def test_chip_smoke_samples_loop_ends():
    """sampling_masked keeps the first and the last add_masked step of each
    chained loop, each once, and the kept steps replay bit-equal."""
    C = bls12_381_g1("cpu")
    P = C.double(C.from_affine_ints([None, None]))
    mask = torch.tensor([True, False])
    steps = []
    with chip_smoke.sampling_masked() as kept:
        for length in (3, 1, 2):
            acc = P
            for _ in range(length):
                acc = C.add_mixed_masked(acc, P, mask)
                steps.append(acc.x)
    assert g1_module.cuda_g1 is cuda_g1
    assert [id(k[2][0]) for k in kept] == [id(steps[i]) for i in (0, 2, 3, 4, 5)]
    assert chip_smoke.replay(kept)[0] == {"g1_add_masked": 5}


def test_non_cuda_tensor_is_refused():
    """Neither CPU nor CUDA: the wrapper raises instead of guessing."""
    spec = get_field("bls12_381_fr", device="cpu").spec
    a = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        cuda_fr.mul(spec, a, a)
    with pytest.raises(TypeError):
        cuda_sumcheck.product_phase(get_field("bls12_381_fr", device="cpu"), a, a, a, 0)
    lm = torch.zeros((16, 1024), dtype=torch.int32, device="meta")
    tiled = torch.zeros((1, 16, 8, 512), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        cuda_fr.mul_limb_major(spec, lm, lm)
    with pytest.raises(TypeError):
        cuda_fr.mul_tiled(spec, tiled, tiled)
    spec = get_field("bls12_381_fq", device="cpu").spec
    pt = (torch.zeros((4, 24), dtype=torch.int32, device="meta"),) * 3
    for call in (lambda: cuda_g1.add(spec, pt, pt), lambda: cuda_g1.double(spec, pt),
                 lambda: cuda_g1.horner(spec, pt, 2), lambda: cuda_g1.bucket_serial(spec, pt),
                 lambda: cuda_g1.scalar_mul(spec, pt, a),
                 lambda: cuda_g1.add_masked(spec, pt, pt, torch.ones(4, dtype=torch.bool)),
                 lambda: cuda_g1.add_reset(spec, pt, pt, torch.ones(4, dtype=torch.bool))):
        with pytest.raises(TypeError):
            call()


def test_phase_plan_and_bound():
    """The fold phase is one launch (no head round) at every M <= 2^13, the
    cluster growing with M to 8 blocks; larger tables fold down to 2^13 in
    head rounds.  Its bound at the gate identity's [6, 2^13] is the
    operations term, 5 products of 264 multiplies a pair and round."""
    plan = cuda_sumcheck.plan
    assert [plan(1 << k) for k in (1, 3, 6, 7, 8, 9, 10, 13)] == [
        (1, 0), (1, 0), (1, 0), (1, 0), (2, 0), (4, 0), (8, 0), (8, 0)]
    assert plan(1 << 14) == (8, 1) and plan(1 << 21) == (8, 8) and plan(1 << 25) == (8, 12)
    F = get_field("bls12_381_fr", device="cpu")
    rate = 132 * 64 * 1.98e9
    row = chip_smoke.phase_bound(F, 6, 1 << 13, rate, 5.0)
    assert row["bound_by"] == "operations" and row["bound_kind"] == "throughput"
    assert row["bound_ms"] == row["operations_ms"] == 6 * 8191 * 5 * 264 / rate * 1e3
    assert row["chain_ms"] == 13 * 38 * 5.0 * 1e-6 < row["operations_ms"]


def test_kernel_operand_periods():
    """The operands of a [3, 4] launch are read in place: a full operand
    in one dim of stride 16 beside a constant of stride 0; a trailing block
    or a leading column beside a full operand in two dims, the broadcast
    dim of stride 0; none copied."""
    shape = torch.Size((3, 4, 16))
    full = torch.zeros(shape, dtype=torch.int32)
    const = torch.zeros(16, dtype=torch.int32)
    block = torch.zeros((1, 4, 16), dtype=torch.int32)
    col = torch.zeros((3, 1, 16), dtype=torch.int32)
    before = cuda_fr.copies
    for a, b, dims, strides in ((full, const, [12], ([16], [0])),
                                (full, block, [3, 4], ([64, 16], [0, 16])),
                                (col, full, [3, 4], ([16, 0], [64, 16]))):
        got_dims, ops = cuda_fr.kernel_operands(shape, a, b)
        assert got_dims == dims and [s for _, s in ops] == list(strides)
        assert ops[0][0] is a and ops[1][0] is b
    assert cuda_fr.copies == before


def test_field_consts():
    spec = get_field("bls12_381_fq", device="cpu").spec
    c = cuda_fr.field_consts(spec)
    assert c.dtype == np.uint32 and len(c) == spec.num_words + 1
    assert sum(int(w) << (32 * k) for k, w in enumerate(c[:-1])) == spec.modulus
    assert (int(c[0]) * int(c[-1])) % (1 << 32) == (1 << 32) - 1  # n0 = -p^-1 mod 2^32
    assert cuda_build._target("fr").parent == PORT / "build"
    g = cuda_g1.g1_consts(spec)
    assert len(g) == 2 * spec.num_words + 1 and list(g[: spec.num_words + 1]) == list(c)
    assert sum(int(w) << (32 * k) for k, w in enumerate(g[spec.num_words + 1:])) == spec.r
    assert set(cuda_build.SOURCES) == {"fr", "sumcheck", "g1", "g1_chain"}


def test_timer_spans(capsys):
    timer.clear()
    timer.enable(True)
    try:
        with timer.trace("outer"):
            with timer.trace("inner step"):
                pass
    finally:
        timer.enable(False)
    assert [label for label, _ in timer.records()] == ["inner step", "outer"]
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "Start: outer" and err[1] == "  Start: inner step"
    assert err[-1].startswith("End:   outer ")
    timer.clear()


@pytest.mark.gpu
def test_card_calls_count_launches(cuda):
    F = get_field("bls12_381_fr", device=cuda)
    f, g, ch = F.random((2, 8), 1), F.random((2, 8), 2), F.random((4,), 3)
    before = cuda_fr.mul.launches, cuda_sumcheck.product_phase.launches
    F.mul(f, g)
    cuda_sumcheck.product_phase(F, f, g, ch, 0)
    assert (cuda_fr.mul.launches, cuda_sumcheck.product_phase.launches) == (
        before[0] + 1, before[1] + 1)  # one mul; one launch a phase at M <= 2^13
    C = bls12_381_g1(cuda)
    before = cuda_g1.add.launches, cuda_g1.double.launches
    P = C.double(C.from_affine_ints([None, None]))
    C.add(P, P)
    assert (cuda_g1.add.launches, cuda_g1.double.launches) == (before[0] + 1, before[1] + 1)
    x = F.random((4096,), 4)
    before = cuda_fr.mul_limb_major.launches, cuda_fr.mul_tiled.launches
    cuda_fr.mul_limb_major(F.spec, exp_fieldmul.to_limb_major(x), exp_fieldmul.to_limb_major(x))
    cuda_fr.mul_tiled(F.spec, exp_fieldmul.to_tiled(x), exp_fieldmul.to_tiled(x))
    assert (cuda_fr.mul_limb_major.launches, cuda_fr.mul_tiled.launches) == (
        before[0] + 1, before[1] + 1)
