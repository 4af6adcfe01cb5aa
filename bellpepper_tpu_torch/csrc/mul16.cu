// Canonical modular multiply of 16-bit-limb field elements: out = a·b mod p.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py PallasFieldOps.mul
// (_mul_kernel: _reduce16_rows(_conv16_rows(a, b))) and
// PallasFieldOps.mul_digits (_mul_digits_kernel: the same, then an 8-bit
// split).
//
// Inputs a, b u32[16, N] limb-major canonical limbs; output u32[16, N]
// canonical (u32[32, N] 8-bit digits for mul_digits). Any correct modular
// multiply gives the same bits (a canonical residue is unique), so the two
// kernels multiply differently:
//
// * mul_kernel works in 32-bit words: each thread joins its element's 16
//   limbs into 8 words on load and multiplies with bp::mulmod_words
//   (field.cuh, chain's multiply): 64 + 64 + 16 mul.wide.u32 products,
//   against the 834 multiplies of the TPU's 16-bit pipeline, then splits
//   the 8 result words back into 16 limb rows on store. All 32 loads issue
//   before any arithmetic. Blocks of 32 threads, so the field backend's
//   N = 8,192 (a witness chunk) spreads 256 warps over every SM rather than
//   64 blocks over 64 of the 132.
// * mul_digits_kernel still runs the TPU kernel's steps (bp::mul_canon) in
//   uint32_t, in blocks of 128 threads.
//
// Design shared by both: one thread per element, coalesced along N
// (neighbouring threads read and write neighbouring words of each limb
// row); operands and temporaries live in registers; the field constants
// arrive as one kernel parameter, so every constant read is a uniform
// constant-bank operand.
//
// What bounds mul on the card: at large N the 192 bytes an element moves
// (its 144 products take the card less time). At N = 8,192 the whole
// launch moves 1.5 MB, below what any launch costs, and the field
// backend's inversion ladder makes about 420 such launches in a row, so
// the host's launch path (field_kernels.pow_ladder validates once and then
// only launches) matters as much as the kernel.
#include "field.cuh"

namespace {

constexpr int kWordThreads = 32;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kWordThreads)
mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int64_t n, const bp::ChainConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWordThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t la[16], lb[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    la[l] = __ldg(a + l * n + i);
    lb[l] = __ldg(b + l * n + i);
  }
  uint32_t wa[8], wb[8], r[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    wa[w] = bp::join16(la[2 * w], la[2 * w + 1]);
    wb[w] = bp::join16(lb[2 * w], lb[2 * w + 1]);
  }
  bp::mulmod_words(wa, wb, k, r);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    out[(2 * w) * n + i] = r[w] & 0xFFFFu;
    out[(2 * w + 1) * n + i] = r[w] >> 16;
  }
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

// consts_host: field_consts.kernel_consts(field)["chain"] (bp::ChainConsts).
extern "C" int bp_mul16(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        int64_t n, const uint32_t* consts_host, void* stream) {
  const bp::ChainConsts k = bp::load_chain_consts(consts_host);
  const int64_t blocks = (n + kWordThreads - 1) / kWordThreads;
  mul_kernel<<<static_cast<unsigned>(blocks), kWordThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(a, b, out, n, k);
  return static_cast<int>(cudaGetLastError());
}
