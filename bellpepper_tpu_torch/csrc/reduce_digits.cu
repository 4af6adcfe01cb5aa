// Canonical reduction of digit sums: out = Σ_d d_sum[d]·2^(8d) mod p.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py PallasFieldOps.
// reduce_digits (_reduce_kernel: _reduce_rows).
//
// Input: per element 32 sums of 8-bit-basis digits, each below 2^24 (the
// non-fused limbs check's and the row-chunked evaluator's row sums; the
// wrapper does not see the sums, so the caller holds the bound, as
// layout._assert_row_density does), in one of two layouts: limb-major
// u32[32, N] (sum j of element i at j·N + i), or element-major u32[N, 32]
// (at 32·i + j: each element's 128 bytes one contiguous line, the layout
// the row-chunked evaluator builds its sums in). Output u32[16, N]
// canonical limbs (limbs past 2W are 0), for every odd p < 2^256. A
// canonical residue is unique, so the bits equal the TPU kernel's, whose
// steps this kernel does not follow.
//
// Design: the TPU's pipeline (three carry passes over 32-36 byte
// positions, two folds and 266 − NUM_BITS shift-subtract borrow chains of
// 17 limbs: 16 for a 250-bit field, 202 for Goldilocks) is gone. One
// thread an element joins four sums into a word with 64-bit adds (9
// words, V < 2^281), folds the words at and above the field's W =
// ceil(NUM_BITS/32) by 2^(32·(W+i)) mod p and finishes with chain's
// quotient-estimate tail (bp::reduce_digit_words → bp::canon_words in
// field.cuh, a template on W): (9 − W)·W + 2W word products, one 64-bit
// high product and a (W + 1)-word borrow chain with two conditional
// subtracts of p. An 8-word field of at least 245 bits (the shipped
// ones) has its own instantiation without the fold: its V already meets
// the estimate's bound, and with the sums in L2 the fold's 8 products
// cost 4-6% (NVIDIA H100 80GB HBM3 at 700 W). The W
// canonical words split into 16 limb rows on store, coalesced along N.
// All of an element's loads issue before any arithmetic; the field
// constants arrive as one kernel parameter (uniform constant-bank
// operands).
//
// Loads. Limb-major: 32 coalesced word loads a thread. Element-major:
// the block copies its contiguous tile with coalesced 16-byte loads into
// shared memory, chunk c of element e at e·8 + (c ^ (e & 7)), so that both
// the stores and each quarter-warp's 16-byte reads of one chunk column hit
// 8 distinct bank groups, then each thread reads its element. (A linear
// tile, as one cp.async.bulk copy would lay it, makes those reads conflict
// 8-way.)
//
// Block size and loads: 128 threads, one element a thread, the tile
// staged. An A/B of build variants of this file (not kept; NVIDIA H100
// 80GB HBM3, 700.00 W, device time with L2 flushed between calls) chose
// it: 0.0105 ms at config 5's chunk of 2^17 element-major elements,
// against 0.0109-0.0113 ms for 32, 64 and 256 threads, 0.0113-0.0115 ms
// for two elements a thread, 0.0127-0.0136 ms for eight 16-byte loads of
// each thread's own line (a warp's load touches 32 lines, 16 bytes of
// each), and 0.0115-0.0118 ms for the same sums limb-major; it was also
// the fastest or within 2% of it at 426,920 and 2^20 elements. At 2^17
// elements 1,024 blocks of 128 threads fill under half the card's warp
// slots, which no longer matters: each thread's chain is short, so the
// kernel waits on its loads, not its arithmetic.
//
// What bounds it on the card: bytes. 192 bytes an element (128 in, 64
// out) against at most 30 word products, which the card does in far less
// time.
#include "field.cuh"

namespace {

constexpr int kThreads = 128;  // elements a block, one a thread

template <bool kElementMajor, int W, bool kFold8>
__global__ void __launch_bounds__(kThreads)
reduce_digits_kernel(const uint32_t* __restrict__ d, uint32_t* __restrict__ out, int64_t n,
                     const bp::ChainConsts k) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = base + threadIdx.x;
  uint32_t acc[32];
  if constexpr (kElementMajor) {
    __shared__ uint4 tile[kThreads * 8];
    const uint4* src = reinterpret_cast<const uint4*>(d + base * 32);
    const int64_t live = n - base < kThreads ? (n - base) * 8 : kThreads * 8;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int g = threadIdx.x + r * kThreads;  // chunk g & 7 of element g >> 3
      const int e = g >> 3;
      if (g < live) tile[e * 8 + ((g & 7) ^ (e & 7))] = __ldg(src + g);
    }
    __syncthreads();
    const int e = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 v = tile[e * 8 + (c ^ (e & 7))];
      acc[4 * c] = v.x;
      acc[4 * c + 1] = v.y;
      acc[4 * c + 2] = v.z;
      acc[4 * c + 3] = v.w;
    }
    if (i >= n) return;
  } else {
    if (i >= n) return;
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = __ldg(d + j * n + i);
  }
  uint32_t r[W], limbs[16];
  bp::reduce_digit_words<W, kFold8>(acc, k, r);
  bp::words_to_limbs(r, limbs);
#pragma unroll
  for (int l = 0; l < 16; ++l) out[l * n + i] = limbs[l];
}

}  // namespace

// element_major = 0: d is u32[32, N]; 1: d is u32[N, 32], 16-byte aligned.
// consts_host: field_consts.kernel_consts(field)["chain"] (bp::ChainConsts).
extern "C" int bp_reduce_digits(const uint32_t* d, uint32_t* out, int64_t n, int element_major,
                                const uint32_t* consts_host, void* stream) {
  const bp::ChainConsts k = bp::load_chain_consts(consts_host);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // an 8-word field of at least 245 bits (shift ≥ 25: s = NUM_BITS − 28 ≥
  // 217) needs no fold of the sum's top word (bp::reduce_digit_words)
  if (k.n_words == 8 && k.shift >= 25) {
    if (element_major)
      reduce_digits_kernel<true, 8, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(d, out, n, k);
    else
      reduce_digits_kernel<false, 8, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(d, out, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  return bp::with_words(k.n_words, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (element_major)
      reduce_digits_kernel<true, W, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(d, out, n, k);
    else
      reduce_digits_kernel<false, W, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(d, out, n, k);
    return static_cast<int>(cudaGetLastError());
  });
}
