"""The port's CUDA sources (``csrc/*.cu``) on the CPU, with the host C++
compiler.

Nothing here can run ``nvcc``, so two checks stand in for it until the
card sees the code:

* every ``.cu`` file passes ``g++ -fsyntax-only`` after the CUDA names are
  stubbed (a header that defines the qualifiers, the built-in indices, the
  vector types and the intrinsics the sources use) and each
  ``kernel<<<...>>>(args)`` launch is rewritten as a call: a typo in a
  kernel fails here, not only on the card;
* the G1 team kernels of ``csrc/g1.cu`` and ``csrc/g1_chain.cu`` (point
  ``add``, the accumulate, the masked adds, the scalar ladder, Horner,
  and bucket-serial beside them) run on
  an emulation of the card: each block's threads are host threads,
  ``__syncthreads`` is a barrier of the block, ``__syncwarp`` one of the
  lanes its mask names, ``__shfl_sync`` a barrier and exchange among
  them, and the PTX carry-flag
  primitives of ``fq_chain.cuh`` are those of ``test_torch_fq_chain.py``
  with a carry flag per thread.  The C entries are called through
  ``ctypes`` on CPU tensors and held bit for bit against the plain
  versions.  This checks the kernels' schedules, shuffles and branches
  (teams of one warp that diverge, a shuffle whose lanes do not all take
  part fails by timeout), not what ptxas makes of them: ``chip_smoke.py``
  and ``tests/test_torch_card.py`` hold the built kernels on the card.

Skips where there is no ``g++``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from test_torch_fq_chain import BEGIN, END, PRIMITIVES

CSRC = Path(__file__).resolve().parents[1] / "scalable_collaborative_zksnark_tpu_torch" / "csrc"
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))

# The CUDA names the sources use, for the host compiler.  The emulation's
# definitions come with EMULATION; -fsyntax-only needs only declarations.
CUDA_RUNTIME = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static  /* the emulation runs one block at a time */
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x = 1, unsigned y = 1, unsigned z = 1) : x(x), y(y), z(z) {}
};
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return cudaSuccess;
}
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
uint32_t __shfl_sync(unsigned mask, uint32_t v, int src, int width = 32);
uint32_t __shfl_down_sync(unsigned mask, uint32_t v, unsigned delta, int width = 32);
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
void* emu_dynamic_smem();
template <class G, class B, class F>
void emu_launch(G grid, B block, size_t smem, cudaStream_t stream, F kernel)
#ifdef SCZK_EMULATE
    ;  /* defined after the kernels, by EMULATION */
#else
{}
#endif
"""

# Blocks run one after another; a block's threads are host threads.  A
# barrier wait that outlasts BARRIER_S means some thread never arrived: a
# shuffle or __syncthreads that not every named thread reached.
EMULATION = r"""
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
constexpr int BARRIER_S = 60;

struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0;
  unsigned long gen = 0;
  explicit Barrier(int n) : n(n) {}
  void release() {
    count = 0;
    ++gen;
    cv.notify_all();
  }
  void wait(const char* what) {
    std::unique_lock<std::mutex> l(m);
    const unsigned long g = gen;
    if (++count >= n) {
      release();
      return;
    }
    if (!cv.wait_for(l, std::chrono::seconds(BARRIER_S), [&] { return gen != g; })) {
      std::fprintf(stderr, "emulation: %s of thread %u never completed\n", what, threadIdx.x);
      std::abort();
    }
  }
  void drop() {  // an exited thread no longer counts
    std::lock_guard<std::mutex> l(m);
    if (--n > 0 && count >= n) release();
  }
};

struct Block {
  std::unique_ptr<Barrier> sync;
  std::mutex lock;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Barrier>> teams;  // (warp, mask)
  std::vector<uint32_t> slot;
  std::vector<unsigned char> smem;
};
Block* block;

Barrier& team(unsigned mask) {
  std::lock_guard<std::mutex> l(block->lock);
  auto& b = block->teams[{threadIdx.x / 32, mask}];
  if (!b) b = std::make_unique<Barrier>(__builtin_popcount(mask));
  return *b;
}

uint32_t exchange(unsigned mask, uint32_t v, unsigned src_lane) {
  const unsigned lane = threadIdx.x % 32, base = threadIdx.x - lane;
  if (!((mask >> lane) & 1u) || !((mask >> src_lane) & 1u)) {
    std::fprintf(stderr, "emulation: shuffle of lane %u outside its mask\n", lane);
    std::abort();
  }
  Barrier& b = team(mask);
  block->slot[threadIdx.x] = v;
  b.wait("a shuffle");
  const uint32_t r = block->slot[base + src_lane];
  b.wait("a shuffle");
  return r;
}
}  // namespace emu

uint32_t __shfl_sync(unsigned mask, uint32_t v, int src, int width) {
  const unsigned lane = threadIdx.x % 32;
  return emu::exchange(mask, v, (lane & ~(unsigned)(width - 1)) + (unsigned)(src % width));
}

uint32_t __shfl_down_sync(unsigned mask, uint32_t v, unsigned delta, int width) {
  const unsigned lane = threadIdx.x % 32, seg = lane & ~(unsigned)(width - 1);
  const unsigned src = lane + delta < seg + (unsigned)width ? lane + delta : lane;
  return emu::exchange(mask, v, src);
}

void __syncthreads() { emu::block->sync->wait("__syncthreads"); }

void __syncwarp(unsigned mask) { emu::team(mask).wait("a __syncwarp"); }

void* emu_dynamic_smem() { return emu::block->smem.data(); }

template <class G, class B, class F>
void emu_launch(G grid, B block, size_t smem, cudaStream_t, F kernel) {
  const dim3 g(grid), b(block);
  for (unsigned by = 0; by < g.y; ++by) {
    for (unsigned bx = 0; bx < g.x; ++bx) {
      emu::Block st;
      st.sync = std::make_unique<emu::Barrier>((int)b.x);
      st.slot.assign((b.x + 31) / 32 * 32, 0u);
      st.smem.assign(smem, 0);
      emu::block = &st;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < b.x; ++t) {
        threads.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          blockDim = b;
          gridDim = g;
          kernel();
          st.sync->drop();
        });
      }
      for (auto& th : threads) th.join();
      emu::block = nullptr;
    }
  }
}
"""

LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)
DYNAMIC_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


def _host_source(text: str) -> str:
    """A CUDA source as host C++: each launch a call of ``emu_launch`` and
    the dynamic shared array a pointer into the block's buffer."""
    text = LAUNCH.sub(lambda m: f"emu_launch({m[2]}, [&] {{ {m[1]}({m[3]}); }});", text)
    return DYNAMIC_SMEM.sub(r"\1* \2 = static_cast<\1*>(emu_dynamic_smem());", text)


def _host_tree(tmp: Path, emulate: bool) -> Path:
    """Every csrc file, rewritten for the host, under ``tmp``, with the
    stub ``cuda_runtime.h``; with ``emulate`` the carry-flag primitives of
    fq_chain.cuh are emulated and the emulation's definitions are
    appended to each ``.cu``."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    for src in CSRC.iterdir():
        text = src.read_text()
        if emulate and src.name == "fq_chain.cuh":
            head, rest = text.split(BEGIN, 1)
            text = (head + PRIMITIVES.replace("static uint32_t CF;", "static thread_local uint32_t CF;")
                    + rest.split(END, 1)[1])
        if src.suffix == ".cu":
            text = _host_source(text) + (EMULATION if emulate else "")
        (tmp / src.name).write_text(text)
    return tmp


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    return cxx


def test_launch_rewrite():
    """The launch rewrite keeps template arguments, a configuration with
    casts and arguments over several lines."""
    src = ("  k<N, 0><<<(m + 1) / 2, 128, 0, static_cast<cudaStream_t>(s)>>>(\n"
           "      a, f(b), (unsigned)m);\n  extern __shared__ Pt win[];")
    assert _host_source(src) == (
        "  emu_launch((m + 1) / 2, 128, 0, static_cast<cudaStream_t>(s), [&] { k<N, 0>(\n"
        "      a, f(b), (unsigned)m); });\n  Pt* win = static_cast<Pt*>(emu_dynamic_smem());")


@pytest.mark.parametrize("name", SOURCES)
def test_cuda_source_compiles_on_host(tmp_path, name):
    """``g++ -fsyntax-only`` of each ``csrc/*.cu`` with the CUDA names
    stubbed and its launches rewritten as calls."""
    cxx = _gxx()
    tree = _host_tree(tmp_path, emulate=False)
    proc = subprocess.run([cxx, "-std=c++17", "-fsyntax-only", "-x", "c++", "-I", str(tree),
                           str(tree / name)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``g1.cu`` and ``g1_chain.cu`` built for the emulation, loaded with
    the wrappers' signatures."""
    cxx = _gxx()
    tree = _host_tree(tmp_path_factory.mktemp("csrc_host"), emulate=True)
    libs = {}
    for name, sigs in (("g1", cuda_g1._SIGNATURES), ("g1_chain", cuda_g1._CHAIN_SIGNATURES)):
        out = tree / f"lib{name}.so"
        subprocess.run([cxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", "-DSCZK_EMULATE",
                        "-x", "c++",
                        "-I", str(tree), "-o", str(out), str(tree / f"{name}.cu")], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


@pytest.fixture(scope="module")
def curve():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield bls12_381_g1("cpu")
    torch.set_num_threads(n)


def _new(spec, shape):
    return tuple(torch.zeros(tuple(shape) + (spec.num_limbs,), dtype=torch.int32)
                 for _ in range(3))


def _ptrs(pt):
    return [a.data_ptr() for a in pt]


def _consts(spec):
    return cuda_g1.g1_consts(spec).ctypes.data


def _assert_points_equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_emulated_team_add(emulated, curve):
    """``add_team_kernel`` (op 0 of ``sczk_g1_point_op``) against
    ``add_plain``: the six edge lanes of ``chip_smoke._edge_points`` in two
    launches of 3 lanes, then 42 random lanes and the edge lanes in one
    launch of 48 (two blocks)."""
    spec = curve.fq.spec
    P = curve.double(chip_smoke.rand_points_flat(curve, 42, 1))
    Q = curve.double(chip_smoke.rand_points_flat(curve, 42, 2))
    p1, p2 = (tuple(a.contiguous() for a in pt) for pt in chip_smoke._edge_points(curve, P, Q))
    for lo, hi in ((42, 45), (45, 48), (0, 48)):
        a, b = (tuple(x[lo:hi].contiguous() for x in pt) for pt in (p1, p2))
        out = _new(spec, (hi - lo,))
        assert emulated["g1"].sczk_g1_point_op(0, *_ptrs(a), *_ptrs(b), *_ptrs(out), hi - lo,
                                                _consts(spec), None) == 0
        _assert_points_equal(out, cuda_g1.add.plain(spec, a, b))


@pytest.mark.parametrize("case", ["collision", "diverging_warp", "random_two_chunks"])
def test_emulated_team_accumulate(emulated, curve, case):
    """``accumulate_team_kernel`` against ``accumulate_plain`` on
    ``chip_smoke.accumulate_cases``: the forced x-collision, the warp whose
    eight teams take resets, adds, cancels, padding and doublings at the
    same steps, and random keys over 72 lanes (a full and a partial
    block) and 70 steps (two staging chunks)."""
    spec = curve.fq.spec
    keys, pid, neg, bases, T, steps = dict(chip_smoke.accumulate_cases(curve))[case]
    bases = tuple(a.contiguous() for a in bases)
    scanned = _new(spec, (steps, T))
    rep = torch.zeros(1, dtype=torch.int32)
    assert emulated["g1"].sczk_g1_accumulate(
        keys.data_ptr(), pid.data_ptr(), neg.data_ptr(), keys.shape[0], *_ptrs(bases), T, steps,
        *_ptrs(scanned), rep.data_ptr(), _consts(spec), None) == 0
    want, doubled = cuda_g1.accumulate_plain(spec, keys, pid, neg, bases, T, steps)
    _assert_points_equal(scanned, want)
    assert int(rep) == doubled
    assert doubled > 0


@pytest.mark.parametrize("case", ["diverging_warp", "short_scalars"])
def test_emulated_team_ladder(emulated, curve, case):
    """``scalar_mul_team_kernel`` against ``scalar_mul_plain`` on
    ``chip_smoke.ladder_cases``: one warp of 4-lane teams on full-width
    scalars that set its teams apart at every bit (0, 1, r - 1, a last add
    that cancels, one that doubles, a base at infinity), and 2-limb
    scalars over a full and a partial block."""
    spec = curve.fq.spec
    pts, sc = dict(chip_smoke.ladder_cases(curve))[case]
    pts, sc = tuple(a.contiguous() for a in pts), sc.contiguous()
    m, n_limbs = sc.shape
    out = _new(spec, (m,))
    assert emulated["g1"].sczk_g1_scalar_mul(*_ptrs(pts), sc.data_ptr(), n_limbs, m, *_ptrs(out),
                                             _consts(spec), None) == 0
    _assert_points_equal(out, cuda_g1.scalar_mul_plain(spec, pts, sc))


@pytest.fixture(scope="module")
def masked_cases(curve):
    return dict(chip_smoke.masked_cases(curve, 64))


@pytest.mark.parametrize("case", ["random", "zeros", "ones", "alternating"])
def test_emulated_team_masked(emulated, curve, masked_cases, case):
    """``masked_op_team_kernel`` (ops 0 ``add_masked`` and 1 ``add_reset``
    of ``sczk_g1_masked_op``) against their plain versions on
    ``chip_smoke.masked_cases``: 64 random points and the six edge lanes,
    140 threads over two blocks, under a random mask (set on the edge
    lanes) and masks of all 0s, all 1s and alternating."""
    spec = curve.fq.spec
    p1, a2, mask = masked_cases[case]
    p1, a2 = (tuple(a.contiguous() for a in pt) for pt in (p1, a2))
    mk = mask.to(torch.uint8).contiguous()
    m = mask.shape[0]
    for op, kern in enumerate((cuda_g1.add_masked, cuda_g1.add_reset)):
        out = _new(spec, (m,))
        assert emulated["g1"].sczk_g1_masked_op(op, *_ptrs(p1), *_ptrs(a2), mk.data_ptr(),
                                                *_ptrs(out), m, _consts(spec), None) == 0
        _assert_points_equal(out, kern.plain(spec, p1, a2, mask))


def test_emulated_chain_kernels(emulated, curve):
    """Horner (8-lane teams on the shared team header) at c = 1 and 4 and
    bucket-serial at S = 1 and 4 on ``chip_smoke.chain_grid``, which makes
    Horner double and cancel."""
    spec = curve.fq.spec
    grid = tuple(a.contiguous() for a in chip_smoke.chain_grid(curve))
    W, C = grid[0].shape[:2]
    lib = emulated["g1_chain"]
    for c in (1, 4):
        out = _new(spec, (C,))
        assert lib.sczk_g1_horner(*_ptrs(grid), W, C, c, *_ptrs(out), _consts(spec), None) == 0
        _assert_points_equal(out, cuda_g1.horner_plain(spec, grid, c))
    for S in (1, 4):
        out = _new(spec, (C,))
        assert lib.sczk_g1_bucket_serial(*_ptrs(grid), W, C, S, *_ptrs(out), _consts(spec),
                                         None) == 0
        _assert_points_equal(out, cuda_g1.bucket_serial_plain(spec, grid, S))
