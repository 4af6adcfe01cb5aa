// Canonical modular multiply of 16-bit-limb field elements: out = a·b mod p.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py PallasFieldOps.mul
// (_mul_kernel: _reduce16_rows(_conv16_rows(a, b))) and
// PallasFieldOps.mul_digits (_mul_digits_kernel: the same, then an 8-bit
// split).
//
// Inputs a, b u32[16, N] limb-major canonical limbs; output u32[16, N]
// canonical. Any correct modular multiply gives the same bits (a
// canonical residue is unique); this one runs the TPU kernel's steps
// (bp::mul_canon in field.cuh) in uint32_t.
//
// Design: one thread per element, coalesced along N (neighbouring threads
// read and write neighbouring words of each limb row); the operands, the
// 32-position accumulator and the fold temporaries live in registers; the
// field constants arrive as one kernel parameter, so every constant read
// is a uniform constant-bank operand.
//
// What bounds it on the card: the 192 bytes an element moves. A modmul
// needs 136 32×32 → 64-bit products at the least (8 × 8 words and a
// Montgomery reduction), which take the card less time than the bytes;
// this 16-bit-limb design issues about three times as many multiplies
// (834). At the witness program's shape (N = B = 8,192, one launch per
// fmul stage) a launch is too small to fill the card, so the launch
// itself is what a stage pays.
#include "field.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mul16_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, int64_t n, const bp::ModConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t a16[16], b16[16], r[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    a16[l] = __ldg(a + l * n + i);
    b16[l] = __ldg(b + l * n + i);
  }
  bp::mul_canon(a16, b16, k, r);
#pragma unroll
  for (int l = 0; l < 16; ++l) out[l * n + i] = r[l];
}

// The same product emitted as 32 canonical 8-bit digits (out u32[32, N],
// digit 2l + h = byte h of limb l), the _mul_digits_kernel counterpart:
// the non-fused limbs check sums these digits over each ELL row.
__global__ void __launch_bounds__(kThreads)
mul_digits_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  uint32_t* __restrict__ out, int64_t n, const bp::ModConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t a16[16], b16[16], r[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    a16[l] = __ldg(a + l * n + i);
    b16[l] = __ldg(b + l * n + i);
  }
  bp::mul_canon(a16, b16, k, r);
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    out[(2 * l) * n + i] = r[l] & 0xFFu;
    out[(2 * l + 1) * n + i] = r[l] >> 8;
  }
}

}  // namespace

extern "C" int bp_mul_digits(const uint32_t* a, const uint32_t* b, uint32_t* out,
                             int64_t n, const uint32_t* consts_host, void* stream) {
  const bp::ModConsts k = bp::load_mod_consts(consts_host);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mul_digits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, b, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_mul16(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        int64_t n, const uint32_t* consts_host, void* stream) {
  const bp::ModConsts k = bp::load_mod_consts(consts_host);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mul16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, b, out, n, k);
  return static_cast<int>(cudaGetLastError());
}
