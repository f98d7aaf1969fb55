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
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.examples import bench_micro, common
from scalable_collaborative_zksnark_tpu_torch.examples import sumcheck as example
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr, mxu
from scalable_collaborative_zksnark_tpu_torch.fields import fr as fr_module
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import mxu_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck as sumcheck_module
from scalable_collaborative_zksnark_tpu_torch.scripts import exp_fieldmul, microbench, mxu_micro
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
    for entry in (exp_fieldmul.main, mxu_micro.main, microbench.main, bench_micro.main):
        with pytest.raises(RuntimeError, match="cuda"):
            entry([])
    for run in (exp_fieldmul.run, mxu_micro.run, microbench.run):
        with pytest.raises(RuntimeError, match="cuda"):
            run()
    with pytest.raises(RuntimeError, match="cuda"):
        common.setup(common.base_parser("x").parse_args([]))
    assert common.setup(common.base_parser("x").parse_args(["--device", "cpu"])).type == "cpu"
    assert get_field("bls12_381_fr", device="cpu").device.type == "cpu"
    assert bls12_381_g1("cpu").device.type == "cpu"
    assert convert.from_numpy(np.zeros((2, 16), np.uint32), "cpu").device.type == "cpu"


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


def test_kernel_operand_periods():
    shape = torch.Size((3, 4, 16))
    full = torch.zeros(shape, dtype=torch.int32)
    assert cuda_fr.kernel_operand(full, shape)[1] == 12
    assert cuda_fr.kernel_operand(torch.zeros(16, dtype=torch.int32), shape)[1] == 1
    assert cuda_fr.kernel_operand(torch.zeros((1, 4, 16), dtype=torch.int32), shape)[1] == 4
    x, period = cuda_fr.kernel_operand(torch.zeros((3, 1, 16), dtype=torch.int32), shape)
    assert period == 12 and tuple(x.shape) == tuple(shape)


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
    assert set(cuda_build.SOURCES) == {"fr", "sumcheck", "g1"}


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
        before[0] + 1, before[1] + 6)  # one mul; two launches per round of M = 8
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
