"""The low-latency Montgomery products of ``csrc/fq_chain.cuh`` on the CPU:
``fq_mul_cc`` (N = 12, Horner's, bucket-serial's and the team kernels')
and ``fr_mul_cc`` (N = 8, the sumcheck fold phase's), the phase's
carry-flag ``fr_add_cc`` and ``fr_sub_cc``, and the carry-flag add and
subtract at N = 12 (``add_mod_cc<12>``, ``sub_mod_cc<12>``, the
elementwise kernel's Fq add and sub in ``csrc/fr.cu``).

The product is CUDA C++ on PTX carry-flag instructions, which nothing here
can run.  This test compiles the header's arithmetic with the host C++
compiler, the PTX primitives replaced by a plain emulation of the same
instructions (a carry flag that each ``.cc`` instruction sets and each
``c``-suffixed one reads), and holds it against Python integers on edge
and random values.  It checks the schedule of the even and odd
accumulators and their carries, not the compiled PTX: ``chip_smoke.py``
and ``tests/test_torch_card.py`` hold the kernel itself against ``fmul``
on the card, and ``fr_mul_cc`` against ``fmul<8>`` likewise.  Skips
where there is no ``g++``.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field

HEADER = (Path(__file__).resolve().parents[1] / "scalable_collaborative_zksnark_tpu_torch"
          / "csrc" / "fq_chain.cuh")
BEGIN, END = "// ---- carry-flag primitives", "// ---- end of primitives ----"

SHIM = """
#include <cstdint>
#define __device__
#define __forceinline__ inline
template <int N> struct FieldConst { uint32_t p[N]; uint32_t n0; };
"""

# PTX semantics: mad.lo/hi.cc add the low/high word of a*b to c and set the
# carry flag CF; madc adds CF in; add/sub(c).cc likewise (CF = borrow for sub).
PRIMITIVES = """
static uint32_t CF;
static inline uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
static inline uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32); }
static inline uint32_t carry(uint64_t s) { CF = (uint32_t)(s >> 32); return (uint32_t)s; }
typedef uint32_t u32;
static inline u32 mad_lo_cc(u32 a, u32 b, u32 c) { return carry((uint64_t)(a * b) + c); }
static inline u32 madc_lo_cc(u32 a, u32 b, u32 c) { return carry((uint64_t)(a * b) + c + CF); }
static inline u32 madc_hi_cc(u32 a, u32 b, u32 c) { return carry((uint64_t)mul_hi(a, b) + c + CF); }
static inline u32 madc_hi(u32 a, u32 b, u32 c) { return mul_hi(a, b) + c + CF; }
static inline uint32_t add_cc(uint32_t a, uint32_t b) { return carry((uint64_t)a + b); }
static inline uint32_t addc_cc(uint32_t a, uint32_t b) { return carry((uint64_t)a + b + CF); }
static inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + CF; }
static inline uint32_t sub_cc(uint32_t a, uint32_t b) { CF = a < b; return a - b; }
static inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a - b - CF; CF = (uint32_t)(s >> 63); return (uint32_t)s; }
static inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - CF; }
"""

MAIN = """
#include <cstdio>
int main() {
  FieldConst<NW> f;
  for (int j = 0; j < NW; ++j) if (scanf("%x", &f.p[j]) != 1) return 1;
  if (scanf("%x", &f.n0) != 1) return 1;
  uint32_t a[NW], b[NW], r[NW];
  for (;;) {
    for (int j = 0; j < NW; ++j) if (scanf("%x", &a[j]) != 1) return 0;
    for (int j = 0; j < NW; ++j) if (scanf("%x", &b[j]) != 1) return 1;
    MUL(r, a, b, f);
    for (int j = 0; j < NW; ++j) printf("%x ", r[j]);
    printf("\\n");
  }
}
"""


def _host_source() -> str:
    src = HEADER.read_text()
    head, rest = src.split(BEGIN, 1)
    tail = rest.split(END, 1)[1]
    return (SHIM + head.replace('#include "fr.cuh"', "") + PRIMITIVES + tail + MAIN)


def _on_host(tmp_path, field: str, op: str, nbytes: int, seed: int, expect):
    """``op`` of fq_chain.cuh (N = words of ``field``) on the host against
    ``expect(x, y, p, R)``, for every pair of edge values (0, 1, p - 1,
    p - 2, R mod p, R^2 mod p, (p - 1) / 2) and for 3,000 random pairs, 500
    of them both just below p."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    spec = get_field(field, device="cpu").spec
    n = spec.num_words
    name = re.sub(r"\W", "_", op)
    src = tmp_path / f"{name}_host.cpp"
    src.write_text(_host_source())
    exe = tmp_path / f"{name}_host"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-DNW={n}", f"-DMUL={op}", "-o", str(exe),
                    str(src)], check=True, capture_output=True)
    q, R = spec.modulus, 1 << (32 * n)
    words = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(n)]  # noqa: E731
    rng = np.random.RandomState(seed)
    rand = lambda: int.from_bytes(rng.bytes(nbytes), "little") % q  # noqa: E731
    edge = [0, 1, q - 1, q - 2, R % q, R * R % q, (q - 1) // 2]
    pairs = [(x, y) for x in edge for y in edge] + [(rand(), rand()) for _ in range(2500)]
    pairs += [(q - 1 - int(rng.randint(1 << 30)), q - 1 - int(rng.randint(1 << 30)))
              for _ in range(500)]
    text = " ".join(f"{w:x}" for w in words(q) + [spec.n0inv32]) + "\n"
    text += "\n".join(" ".join(f"{w:x}" for w in words(x) + words(y)) for x, y in pairs)
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True,
                         check=True).stdout.splitlines()
    got = [sum(int(w, 16) << (32 * k) for k, w in enumerate(line.split())) for line in out]
    assert got == [expect(x, y, q, R) for x, y in pairs]


def _product(x, y, q, R):
    return x * y * pow(R, -1, q) % q


def test_fq_mul_cc_schedule_on_host(tmp_path):
    """a b 2^-384 mod q, canonical, for every pair of edge values (0, 1,
    q - 1, q - 2, R mod q, R^2 mod q, (q - 1) / 2) and for 3,000 random
    pairs, 500 of them both just below q."""
    _on_host(tmp_path, "bls12_381_fq", "fq_mul_cc", 48, 7, _product)


def test_fr_mul_cc_schedule_on_host(tmp_path):
    """The same for the N = 8 instance: a b 2^-256 mod r on BLS12-381's
    scalar field, whose modulus leaves one spare bit (r < 2^255) where q
    leaves two."""
    _on_host(tmp_path, "bls12_381_fr", "fr_mul_cc", 32, 8, _product)


@pytest.mark.parametrize("op", ["fr_add_cc", "fr_sub_cc"])
def test_fr_add_sub_cc_on_host(tmp_path, op):
    """The phase's carry-flag a + b and a - b mod r, canonical, on the same
    edge and random pairs."""
    sign = 1 if op == "fr_add_cc" else -1
    _on_host(tmp_path, "bls12_381_fr", op, 32, 9, lambda x, y, q, R: (x + sign * y) % q)


@pytest.mark.parametrize("op", ["fqcc::add_mod_cc<12>", "fqcc::sub_mod_cc<12>"])
def test_fq_add_sub_cc_on_host(tmp_path, op):
    """The same carry-flag a + b and a - b at N = 12, mod q, canonical, on
    the edge and random pairs of the Fq product's test."""
    sign = 1 if "add" in op else -1
    _on_host(tmp_path, "bls12_381_fq", op, 48, 10, lambda x, y, q, R: (x + sign * y) % q)
