"""The port's CUDA sources (``csrc/*.cu``) on the CPU, with the host C++
compiler.

Nothing here can run ``nvcc``, so two checks stand in for it until the
card sees the code:

* every ``.cu`` file passes ``g++ -fsyntax-only`` after the CUDA names are
  stubbed (a header that defines the qualifiers, the built-in indices, the
  vector types and the intrinsics the sources use) and each
  ``kernel<<<...>>>(args)`` launch is rewritten as a call: a typo in a
  kernel fails here, not only on the card;
* the elementwise kernel of ``csrc/fr.cu`` (small and staged launches,
  operands read through their strides), the G1 team kernels of
  ``csrc/g1.cu`` and ``csrc/g1_chain.cu`` (point ``add``, ``add_mixed``
  and ``double``, the accumulate, the masked adds, the scalar ladder,
  Horner, and bucket-serial beside them) and the fold phase of
  ``csrc/sumcheck.cu`` (its cluster kernel and head rounds) run on an
  emulation of the card:
  each block's threads are host threads, static ``__shared__`` arrays are
  one buffer that the blocks, run one after another, share (each block
  finds what the last one left), ``__syncthreads`` is a barrier of the
  block, ``__syncwarp`` one of the lanes its mask names,
  ``__shfl_sync`` a barrier and exchange among them; a cluster's blocks
  run together, each with its own dynamic shared memory (not zeroed),
  ``cluster.sync()`` is a barrier of the cluster and ``map_shared_rank``
  maps an offset into another block's shared memory; the PTX carry-flag
  primitives of ``fq_chain.cuh`` are those of ``test_torch_fq_chain.py``
  with a carry flag per thread.  The C entries are called through
  ``ctypes`` on CPU tensors and held bit for bit against the plain
  versions.  This checks the kernels' schedules, shuffles, barriers and
  branches (teams of one warp that diverge, a shuffle or barrier that not
  every named thread reaches fails by timeout, a skipped cluster.sync or
  a block that may exit before another reads its shared memory fails at
  once), not what ptxas makes of them: ``chip_smoke.py`` and
  ``tests/test_torch_card.py`` hold the built kernels on the card.

Skips where there is no ``g++``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
/* the emulation's card: 2 SMs, 3 blocks of any kernel an SM */
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 3;
  return cudaSuccess;
}
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; size_t sharedSizeBytes; };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  a->sharedSizeBytes = 0;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return cudaSuccess; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
uint32_t __shfl_sync(unsigned mask, uint32_t v, int src, int width = 32);
uint32_t __shfl_down_sync(unsigned mask, uint32_t v, unsigned delta, int width = 32);
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
void* emu_dynamic_smem();
void* emu_map_shared(const void* p, int rank);
template <class G, class B, class F>
void emu_launch(G grid, B block, size_t smem, cudaStream_t stream, F kernel,
                unsigned cluster = 1)
#ifdef SCZK_EMULATE
    ;  /* defined after the kernels, by EMULATION */
#else
{}
#endif
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(E...), A&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      cluster = cfg->attrs[i].val.clusterDim.x;
    }
  }
  emu_launch(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cfg->stream,
             [&] { kernel(args...); }, cluster);
  return cudaSuccess;
}
"""

# The cluster API the sources use (cooperative_groups::this_cluster()).
COOPERATIVE_GROUPS = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const;
  unsigned block_rank() const;
  unsigned num_blocks() const;
  template <class T>
  T* map_shared_rank(T* addr, int rank) const {
    return static_cast<T*>(emu_map_shared(addr, rank));
  }
};
cluster_group this_cluster();
}  // namespace cooperative_groups
"""

# Clusters run one after another, the blocks of a cluster together; a
# block's threads are host threads.  A barrier wait that outlasts
# SCZK_EMU_BARRIER_S (60 s unless defined) means some thread never arrived:
# a shuffle, __syncthreads or cluster.sync that not every named thread
# reached.  A cluster.sync whose threads arrive from different call sites
# (one thread skipped a cluster.sync and arrived at the next) fails at once,
# and so does a launch in which a block may have exited before another
# read its shared memory (no cluster.sync between the read and the exit).
# Dynamic shared memory starts as 0xA5 bytes, not zeros.
EMULATION = r"""
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
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

#ifndef SCZK_EMU_BARRIER_S
#define SCZK_EMU_BARRIER_S 60
#endif

thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0;
  std::atomic<unsigned long> gen{0};
  const void* site = nullptr;  // the call site of this generation (cluster.sync)
  explicit Barrier(int n) : n(n) {}
  void release() {
    count = 0;
    site = nullptr;
    ++gen;
    cv.notify_all();
  }
  void wait(const char* what, const void* from = nullptr) {
    std::unique_lock<std::mutex> l(m);
    if (from) {
      if (count && site != from) {
        std::fprintf(stderr, "emulation: %s of thread %u of block %u arrives from another "
                     "call site than the threads before it\n", what, threadIdx.x, blockIdx.x);
        std::abort();
      }
      site = from;
    }
    const unsigned long g = gen;
    if (++count >= n) {
      release();
      return;
    }
    l.unlock();  // a short spin first: most barriers complete within it
    for (int k = 0; k < 64; ++k) {
      if (gen.load() != g) return;
      std::this_thread::yield();
    }
    l.lock();
    if (!cv.wait_for(l, std::chrono::seconds(SCZK_EMU_BARRIER_S), [&] { return gen != g; })) {
      std::fprintf(stderr, "emulation: %s of thread %u of block %u never completed\n", what,
                   threadIdx.x, blockIdx.x);
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
  // cluster.syncs done: fewest by any of its threads at exit; most, plus
  // one, by another block's thread at a read of its shared memory
  unsigned exit_syncs = ~0u, read_syncs = 0;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Barrier>> teams;  // (warp, mask)
  std::vector<uint32_t> slot[2];
  std::vector<unsigned char> smem;
};

struct Cluster {
  std::unique_ptr<Barrier> sync;
  std::vector<Block*> blocks;
};

thread_local Block* block;
thread_local Cluster* cluster;
thread_local unsigned rank, syncs;
thread_local std::map<const Barrier*, unsigned> shuffles;  // a thread's shuffles a team

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
  // one barrier a shuffle: the team's shuffles alternate between two
  // slot rows, and a row is written again only after the next barrier,
  // which every lane reaches after its read of the row
  Barrier& b = team(mask);
  const unsigned row = shuffles[&b]++ & 1u;
  block->slot[row][threadIdx.x] = v;
  b.wait("a shuffle");
  return block->slot[row][base + src_lane];
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

// The same offset in block `rank`'s dynamic shared memory.
void* emu_map_shared(const void* p, int rank) {
  const auto& own = emu::block->smem;
  const size_t off = static_cast<const unsigned char*>(p) - own.data();
  if (off >= own.size() || rank < 0 || (size_t)rank >= emu::cluster->blocks.size()) {
    std::fprintf(stderr, "emulation: map_shared_rank outside dynamic shared memory or the "
                 "cluster\n");
    std::abort();
  }
  emu::Block* other = emu::cluster->blocks[rank];
  if ((unsigned)rank != emu::rank) {
    std::lock_guard<std::mutex> l(other->lock);
    other->read_syncs = std::max(other->read_syncs, emu::syncs + 1);
  }
  return other->smem.data() + off;
}

namespace cooperative_groups {
__attribute__((noinline)) void cluster_group::sync() const {
  emu::cluster->sync->wait("cluster.sync", __builtin_return_address(0));
  ++emu::syncs;
}
unsigned cluster_group::block_rank() const { return emu::rank; }
unsigned cluster_group::num_blocks() const { return (unsigned)emu::cluster->blocks.size(); }
cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

template <class G, class B, class F>
void emu_launch(G grid, B block, size_t smem, cudaStream_t, F kernel, unsigned cluster) {
  const dim3 g(grid), b(block);
  if (cluster == 0 || g.x % cluster) {
    std::fprintf(stderr, "emulation: grid %u is not a multiple of the cluster %u\n", g.x,
                 cluster);
    std::abort();
  }
  for (unsigned by = 0; by < g.y; ++by) {
    for (unsigned bx = 0; bx < g.x; bx += cluster) {
      emu::Cluster cl;
      cl.sync = std::make_unique<emu::Barrier>((int)(b.x * cluster));
      std::vector<std::unique_ptr<emu::Block>> blocks;
      for (unsigned k = 0; k < cluster; ++k) {
        blocks.push_back(std::make_unique<emu::Block>());
        blocks[k]->sync = std::make_unique<emu::Barrier>((int)b.x);
        for (auto& row : blocks[k]->slot) row.assign((b.x + 31) / 32 * 32, 0u);
        blocks[k]->smem.assign(smem, 0xA5);  // not zeroed, as on the card
        cl.blocks.push_back(blocks[k].get());
      }
      std::vector<std::thread> threads;
      for (unsigned k = 0; k < cluster; ++k) {
        for (unsigned t = 0; t < b.x; ++t) {
          threads.emplace_back([&, k, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx + k, by);
            blockDim = b;
            gridDim = g;
            emu::block = blocks[k].get();
            emu::cluster = &cl;
            emu::rank = k;
            emu::syncs = 0;
            kernel();
            blocks[k]->sync->drop();
            cl.sync->drop();
            std::lock_guard<std::mutex> l(blocks[k]->lock);
            blocks[k]->exit_syncs = std::min(blocks[k]->exit_syncs, emu::syncs);
          });
        }
      }
      for (auto& th : threads) th.join();
      for (unsigned k = 0; k < cluster; ++k) {  // its shared memory outlived every remote read
        if (blocks[k]->read_syncs > blocks[k]->exit_syncs) {
          std::fprintf(stderr, "emulation: block %u may exit while another block reads its "
                       "shared memory (no cluster.sync between)\n", bx + k);
          std::abort();
        }
      }
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
    (tmp / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
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


@pytest.mark.parametrize("op", ["add_mixed", "double"])
def test_emulated_team_point_ops(emulated, curve, op):
    """``point_op_team_kernel`` (ops 1 ``add_mixed`` and 2 ``double`` of
    ``sczk_g1_point_op``) against the plain versions: the six edge lanes of
    ``chip_smoke._edge_points`` (infinity on either side and both, an
    equal pair that doubles, equal points in other forms, P + (-P)) in two
    launches of 3 lanes, then 64 random lanes and the edge lanes in one
    launch of 70 (2-lane teams, two blocks, the edge lanes' teams
    diverging in their warp); the right operand of ``add_mixed`` affine."""
    spec = curve.fq.spec
    P = curve.double(chip_smoke.rand_points_flat(curve, 64, 3))
    Q = curve.double(chip_smoke.rand_points_flat(curve, 64, 4))
    p1, p2 = chip_smoke._edge_points(curve, P, Q)
    p1, p2 = (tuple(a.contiguous() for a in pt) for pt in (p1, curve.normalize(p2)))
    kern = getattr(cuda_g1, op)
    for lo, hi in ((64, 67), (67, 70), (0, 70)):
        a, b = (tuple(x[lo:hi].contiguous() for x in pt) for pt in (p1, p2))
        out = _new(spec, (hi - lo,))
        assert emulated["g1"].sczk_g1_point_op(cuda_g1._OPS[op], *_ptrs(a), *_ptrs(b),
                                                *_ptrs(out), hi - lo, _consts(spec), None) == 0
        want = kern.plain(spec, a, b) if op == "add_mixed" else kern.plain(spec, a)
        _assert_points_equal(out, want)


@pytest.mark.parametrize("case", ["collision", "diverging_warp", "random_two_chunks",
                                  "one_bucket", "ragged_digit0", "many_blocks"])
def test_emulated_team_accumulate(emulated, curve, case):
    """``accumulate_team_kernel`` and ``accumulate_team_kernel_join``
    against ``accumulate_plain`` on ``chip_smoke.accumulate_cases``: the
    forced x-collision, the warp whose eight teams take resets, adds,
    cancels, padding and doublings at the same steps, random keys over 72
    lanes (a full and a partial block) and 70 steps (two staging chunks),
    one bucket over every lane and a block boundary, empty buckets and
    digit 0 with E not a multiple of T, and 130 blocks (two a team of the
    join) with chains of whole blocks; bit for bit, with the same count of
    adds that doubled.  The output starts as 0xA5 bytes: the kernels
    write every bucket."""
    spec = curve.fq.spec
    keys, pid, neg, bases, T, NB, K = dict(chip_smoke.accumulate_cases(curve))[case]
    bases = tuple(a.contiguous() for a in bases)
    G = -(-T // cuda_g1.SCAN_LANES)
    out = tuple(torch.full((NB, spec.num_limbs), -0x5A5A5A5B, dtype=torch.int32)
                for _ in range(3))
    scratch = _new(spec, (2 * G,))
    meta = torch.zeros(3 * G, dtype=torch.int32)
    rep = torch.zeros(1, dtype=torch.int32)
    assert emulated["g1"].sczk_g1_accumulate(
        keys.data_ptr(), pid.data_ptr(), neg.data_ptr(), keys.shape[0], *_ptrs(bases), T, NB, K,
        *_ptrs(out), *_ptrs(scratch), meta.data_ptr(), rep.data_ptr(), _consts(spec), None) == 0
    want, doubled = cuda_g1.accumulate_plain(spec, keys, pid, neg, bases, T, NB, K)
    _assert_points_equal(out, want)
    assert int(rep) == doubled
    assert doubled > 0


def test_emulated_accumulate_lanes(emulated):
    """``sczk_g1_accumulate_lanes``: blocks an SM at the walk's occupancy
    times the SMs times its 64 lanes a block, on the emulation's card of 2
    SMs that holds 3 blocks of any kernel."""
    out = np.zeros(3, dtype=np.int32)
    assert emulated["g1"].sczk_g1_accumulate_lanes(out.ctypes.data) == 0
    assert out.tolist() == [3 * 2 * cuda_g1.SCAN_LANES, 3, 2]


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


def _build(tree: Path, name: str, sigs: dict, *flags) -> ctypes.CDLL:
    """``tree/<name>.cu`` built for the emulation and loaded with ``sigs``."""
    out = tree / f"lib{name}.so"
    subprocess.run([_gxx(), "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", "-DSCZK_EMULATE",
                    *flags, "-x", "c++", "-I", str(tree), "-o", str(out), str(tree / f"{name}.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def fr_lib(tmp_path_factory):
    """``fr.cu`` built for the emulation."""
    _gxx()
    tree = _host_tree(tmp_path_factory.mktemp("csrc_host"), emulate=True)
    return _build(tree, "fr", cuda_fr._SIGNATURES)


@pytest.mark.parametrize("case", ["edge", "transposed", "stepped", "middle_broadcast",
                                  "outer_product", "trailing_block", "constant", "misaligned",
                                  "partial_tiles"])
@pytest.mark.parametrize("field", ["bls12_381_fr", "bls12_381_fq"])
def test_emulated_binary(fr_lib, field, case):
    """``sczk_fr_binary`` (mul, add, sub; small and staged launches) on
    ``chip_smoke.binary_cases`` (its outer product at [16, 1] x [1, 24])
    against the plain versions, bit for bit; no operand copied."""
    F = get_field(field, device="cpu")
    a, b = chip_smoke.binary_cases(F, outer=(16, 24))[case]
    before = cuda_fr.copies
    for op in ("mul", "add", "sub"):
        want = getattr(cuda_fr, f"{op}_plain")(F.spec, a, b)
        for staged in (False, True):
            got = cuda_fr.run_binary(fr_lib, op, F.spec, a, b, None, staged)
            assert torch.equal(got, want), (op, staged)
    assert cuda_fr.copies == before


def test_emulated_binary_refuses(fr_lib):
    """A rank beyond the kernel's, a negative stride or an output that is
    not 16-byte aligned is refused, not launched."""
    spec = get_field("bls12_381_fr", device="cpu").spec
    x = torch.zeros((2, 16), dtype=torch.int32)
    out = torch.zeros(20, dtype=torch.int32)
    consts = cuda_fr.field_consts(spec).ctypes.data
    for rank, layout, o in ((5, [1] * 5 + [0] * 10, out), (1, [2, 16, -16], out),
                            (1, [1, 0, 0], out[1:])):
        arr = np.array(layout, dtype=np.int64)
        assert fr_lib.sczk_fr_binary(0, 8, x.data_ptr(), x.data_ptr(), o.data_ptr(), rank,
                                     arr.ctypes.data, 0, consts, None) == 1
    assert torch.equal(out, torch.zeros(20, dtype=torch.int32))


@pytest.fixture(scope="module")
def phase_lib(tmp_path_factory):
    """``sumcheck.cu`` built for the emulation."""
    _gxx()
    tree = _host_tree(tmp_path_factory.mktemp("csrc_host"), emulate=True)
    return _build(tree, "sumcheck", cuda_sumcheck._SIGNATURES)


def _phase_tables(F, B: int, M: int, seed: int):
    """Seeded f, g [B, M] with 0, 1 and p - 1 in the first slot, and the
    challenges (one of them 0, one 1, one p - 1)."""
    f, g = F.random((B, M), seed), F.random((B, M), seed + 1)
    edge = F.array_from_ints([0, 1, F.p - 1])
    n = min(M, 3)
    f[0, :n], g[0, -n:] = edge[:n], edge[-n:]
    ch = F.random((M.bit_length() + 4,), seed + 2)
    ch[2:5] = edge
    return f, g, ch


# (M, K, head): every M of a few rounds with one and two blocks a cluster
# (M = 2, K = 2 holds one element a block; M = 512 has teams of 2, 4 and 8
# lanes a pair), one whose first round has a pair for every thread, and one
# whose table takes two head rounds (both halves of the head tables'
# scratch) before its cluster
PHASE_CASES = ([(M, K, 0) for M in (2, 8, 64, 512) for K in (1, 2)]
               + [(1024, 1, 0), (128, 2, 2)])


@pytest.mark.parametrize("M,K,head", PHASE_CASES)
def test_emulated_phase(phase_lib, M, K, head):
    """``sczk_product_phase`` (the cluster kernel, after ``head`` streaming
    head rounds) against ``product_phase_plain`` at B = 2, bit for bit:
    every message and both finals, from challenge 2 on."""
    F = get_field("bls12_381_fr", device="cpu")
    f, g, ch = _phase_tables(F, 2, M, M + K + head)
    msgs, ff, fg = cuda_sumcheck.run_phase(phase_lib, F.spec, f, g, ch, 2, K, head, None)
    pm, pf, pg = cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, 2)
    assert torch.equal(msgs, torch.stack(pm, dim=1))
    assert torch.equal(ff, pf) and torch.equal(fg, pg)


def test_emulated_phase_refuses(phase_lib):
    """A cluster that is not 1, 2, 4 or 8 blocks, one larger than the
    table, or head rounds without their scratch are refused, not launched;
    a phase without head rounds needs no scratch."""
    F = get_field("bls12_381_fr", device="cpu")
    f, g, ch = _phase_tables(F, 1, 8, 5)
    for K, head in ((3, 0), (16, 0), (8, 2)):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            cuda_sumcheck.run_phase(phase_lib, F.spec, f, g, ch, 0, K, head, None)
    z = torch.zeros(8, dtype=torch.int32)
    assert phase_lib.sczk_product_phase(f.data_ptr(), g.data_ptr(), ch.data_ptr(), *[z.data_ptr()] * 3,
                                        None, 8, 1, 1, 1,
                                        cuda_fr.field_consts(F.spec).ctypes.data, None) == 1
    words = np.zeros(1, dtype=np.int64)
    assert phase_lib.sczk_phase_scratch_words(8, 1, 0, words.ctypes.data) == 0 and words[0] == 0


MISSED = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void missed_kernel(int how, int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const bool odd_one = cluster.block_rank() == 1 && threadIdx.x == 5;
  if (how == 0 && !odd_one) cluster.sync();  // one thread skips a cluster.sync
  if (how == 1 && odd_one) __syncthreads();  // one thread waits at another barrier
  if (how == 1 && !odd_one) cluster.sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = 1;
  cluster.sync();
}
int main(int argc, char** argv) {
  static int out[64];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(32);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, missed_kernel, argv[1][0] - '0', out);
  return 0;
}
"""


@pytest.mark.parametrize("how,message", [(0, "another call site"), (1, "never completed"),
                                         (2, None)])
def test_emulation_fails_a_missed_cluster_barrier(tmp_path, how, message):
    """A cluster of two 32-thread blocks in which one thread skips a
    ``cluster.sync`` (it arrives at the next one) or waits at
    ``__syncthreads`` while the others wait at ``cluster.sync``: the
    emulation aborts, naming the fault (a 2 s barrier timeout here).  With
    every thread at every barrier (how 2) it runs to its end."""
    tree = _host_tree(tmp_path / "tree", emulate=True)
    (tree / "missed.cu").write_text(_host_source(MISSED) + EMULATION)
    exe = tmp_path / "missed"
    subprocess.run([_gxx(), "-std=c++17", "-O1", "-pthread", "-DSCZK_EMULATE",
                    "-DSCZK_EMU_BARRIER_S=2", "-x", "c++", "-I", str(tree), "-o", str(exe),
                    str(tree / "missed.cu")], check=True, capture_output=True)
    run = subprocess.run([str(exe), str(how)], capture_output=True, text=True, timeout=60)
    if message is None:
        assert run.returncode == 0, run.stderr
    else:
        assert run.returncode != 0 and message in run.stderr
