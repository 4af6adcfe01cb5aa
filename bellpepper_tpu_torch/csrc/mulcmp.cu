// Fused satisfiability compare on semi-reduced operands: the mask
// a·b ≢ c (mod p) of the product rows of every check.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py make_mulcmp
// (_mulcmp_kernel, _mulcmp_rows, _mont_zero_rows).
//
// Inputs a, b, c u32[17, N]: 16-bit limbs of values a, b < 2^266 and
// c ≤ p·2^11 (the semi form of the fold matvecs and the assembled
// operands of the trivial rows). Output u32[N]: 1 where a·b ≢ c (mod p),
// 0 where a·b ≡ c. The TPU kernel's nonzero word is an OR of limb XORs
// that depends on its own fold integers; every caller reads only whether
// it is zero, which is this mask (the plain version returns the same 0/1).
//
// What bounds it on the card: the 208 bytes a column moves (3 × 17 limb
// words in, one out). The TPU's 16-bit-limb pipeline (289 split products,
// 576 fold multiply-adds and a Montgomery zero-test: about 2,500
// instructions a column) would be bound by integer operations instead.
//
// Design: one thread per column, loads coalesced along N (all 51 issued
// before any arithmetic, so each thread keeps 204 bytes in flight). Limb
// pairs become 9 32-bit words an operand; bp::mulcmp_words (field.cuh)
// forms a·b + (p·2^11 − c) with 81 mul.wide.u32 products and makes a
// 9-word Montgomery reduction of it (81 more), then tests the result
// against 0 and p: about 600 instructions a column, few enough for the
// bytes to bound it. The constants arrive as one kernel parameter
// (constant bank, uniform reads).
#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mulcmp_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
              int64_t n, const bp::MulcmpConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t la[17], lb[17], lc[17];
#pragma unroll
  for (int l = 0; l < 17; ++l) {
    la[l] = __ldg(a + l * n + i);
    lb[l] = __ldg(b + l * n + i);
    lc[l] = __ldg(c + l * n + i);
  }
  uint32_t wa[9], wb[9], wc[9];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    wa[w] = bp::join16(la[2 * w], la[2 * w + 1]);
    wb[w] = bp::join16(lb[2 * w], lb[2 * w + 1]);
    wc[w] = bp::join16(lc[2 * w], lc[2 * w + 1]);
  }
  wa[8] = la[16];
  wb[8] = lb[16];
  wc[8] = lc[16];
  out[i] = bp::mulcmp_words(wa, wb, wc, k);
}

}  // namespace

extern "C" int bp_mulcmp(const uint32_t* a, const uint32_t* b,
                         const uint32_t* c, uint32_t* out, int64_t n,
                         const uint32_t* consts_host, void* stream) {
  bp::MulcmpConsts k;
  const uint32_t* s = consts_host;
  for (int w = 0; w < 9; ++w) k.p2_11[w] = *s++;
  for (int w = 0; w < 8; ++w) k.p[w] = *s++;
  k.pinv = *s;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mulcmp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, c, out, n, k);
  return static_cast<int>(cudaGetLastError());
}
