// Canonical modular multiply of 16-bit-limb field elements: out = a·b mod p.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py PallasFieldOps.mul
// (_mul_kernel: _reduce16_rows(_conv16_rows(a, b))) and
// PallasFieldOps.mul_digits (_mul_digits_kernel: the same, then an 8-bit
// split).
//
// Inputs a, b u32[16, N] limb-major 16-bit limbs: a < 2^256 (a canonical
// value, or a raw witness value in [p, 2^256) as config 5's z and the
// limbs checks' gathered z are), b canonical, for every odd p < 2^256
// (the word tail of field.cuh; b is read as the field's W =
// ceil(NUM_BITS/32) words, its 2W low limbs). Output u32[16, N] canonical
// limbs (mul), or u32[32, N] canonical 8-bit digits, digit 2l + h = byte
// h of limb l (mul_digits); limbs past 2W are 0. A canonical residue is
// unique, so any correct modular multiply gives the TPU kernels' bits.
//
// Design: both kernels are one template, instantiated for each W. Each
// thread joins its element's limbs into 8 words of a and W of b on load
// and multiplies with bp::mulmod_words (field.cuh, chain's multiply):
// 8W + 8W + 2W mul.wide.u32 products (64 + 64 + 16 at W = 8),
// against the 834 multiplies of the TPU's 16-bit pipeline, then splits
// the 8 result words into 16 limb rows (mul) or 32 digit rows (mul_digits:
// digit 4w + h is byte h of word w) on store. One thread per element,
// coalesced along N (neighbouring threads read and write neighbouring
// words of each row); all 32 loads issue before any arithmetic; operands
// and temporaries live in registers; the field constants arrive as one
// kernel parameter, so every constant read is a uniform constant-bank
// operand. Blocks of 32 threads, so the field backend's N = 8,192 (a
// witness chunk) spreads 256 warps over every SM rather than 64 blocks
// over 64 of the 132. mul_digits ran the TPU's 16-bit pipeline
// (bp::mul_canon) until this design replaced it.
//
// What bounds them on the card: at large N the bytes an element moves,
// 192 for mul and 256 for mul_digits (the 144 products take the card less
// time). At N = 8,192 a mul launch moves 1.5 MB, below what any launch
// costs, and the field backend's inversion ladder makes about 420 such
// launches in a row, so the host's launch path (field_kernels.pow_ladder
// validates once and then only launches) matters as much as the kernel.
#include "field.cuh"

namespace {

constexpr int kThreads = 32;

template <bool kDigits, int W>
__global__ void __launch_bounds__(kThreads)
mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int64_t n, const bp::ChainConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t la[16], lb[2 * W];
#pragma unroll
  for (int l = 0; l < 16; ++l) la[l] = __ldg(a + l * n + i);
#pragma unroll
  for (int l = 0; l < 2 * W; ++l) lb[l] = __ldg(b + l * n + i);
  uint32_t wa[8], wb[W], r[W];
#pragma unroll
  for (int w = 0; w < 8; ++w) wa[w] = bp::join16(la[2 * w], la[2 * w + 1]);
#pragma unroll
  for (int w = 0; w < W; ++w) wb[w] = bp::join16(lb[2 * w], lb[2 * w + 1]);
  bp::mulmod_words<W, 8>(wa, wb, k, r);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t x = w < W ? r[w < W ? w : 0] : 0u;
    if constexpr (kDigits) {
#pragma unroll
      for (int h = 0; h < 4; ++h) out[(4 * w + h) * n + i] = (x >> (8 * h)) & 0xFFu;
    } else {
      out[(2 * w) * n + i] = x & 0xFFFFu;
      out[(2 * w + 1) * n + i] = x >> 16;
    }
  }
}

template <bool kDigits>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n, const uint32_t* consts_host,
           void* stream) {
  const bp::ChainConsts k = bp::load_chain_consts(consts_host);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return bp::with_words(k.n_words, [&](auto w) {
    mul_kernel<kDigits, decltype(w)::value>
        <<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, n, k);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// consts_host: field_consts.kernel_consts(field)["chain"] (bp::ChainConsts).
extern "C" int bp_mul16(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        int64_t n, const uint32_t* consts_host, void* stream) {
  return launch<false>(a, b, out, n, consts_host, stream);
}

extern "C" int bp_mul_digits(const uint32_t* a, const uint32_t* b, uint32_t* out,
                             int64_t n, const uint32_t* consts_host, void* stream) {
  return launch<true>(a, b, out, n, consts_host, stream);
}
