// Bucket matvec with a static 8-bit fold matrix: the field-exact rows of
// the bits form (x = witness bits) and every row of the fused limbs form
// (x = witness digits), with the semi-reduced or the canonical output.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py make_fold_matvec_bucket,
// as reached through make_bits_matvec_bucket(..., out_form="semi") and
// make_limbs_matvec_bucket(..., out_form="semi" or "canonical").
//
// Inputs x u32[n_rows, C, B] (values below 256, one instance per word:
// bits, or the 8-bit digits of K field elements with C = 32K, k-major and
// j-minor) and F u32[32, n_rows, C] (8-bit fold planes: a coefficient's
// digits for bits, digit d of c·2^(8j) mod p for digits). For every row r
// and instance b it forms the exact digit sums acc[d] = Σ_c F[d, r, c]·
// x[r, c, b] (the wrapper holds C·255² < 2^32) and reduces them in
// registers to 17 semi-reduced limbs (field_pallas._semi_reduce_rows) or
// 16 canonical limbs (_reduce_rows), bit-identical to the TPU kernel.
// Output u32[17 or 16, n_rows, B].
//
// Design: one thread per (row, instance), coalesced along B, with the 32
// digit sums in registers. A block shares one row: it stages the row's
// fold planes in shared memory 32 entries at a time (padded to avoid bank
// conflicts on the store; every read is a broadcast), so each witness word
// read costs 32 register multiply-adds. Each thread issues a full chunk's
// 32 witness loads together, before the staging, so a block of a wide
// bucket with few rows (few warps on its SM) still keeps loads in flight.
// The TPU's bf16 MXU chunks (exact below 2^24) and its row/K tiling are TPU
// choices and are not ported: uint32 sums are exact to the wrapper's
// bound, so one pass covers C.
//
// What bounds it on the card: for bits, bytes (x is read once, 4 bytes per
// entry and instance, for 32 IMADs); for digits, the 32 IMADs and 32
// shared-memory broadcasts per x word, since the function itself needs only
// one 8×8-word product per ELL entry, which the digit form spends 1,024
// multiply-adds on.
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

template <bool kCanonical>
__global__ void __launch_bounds__(kThreads)
fold_matvec_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ F, uint32_t* __restrict__ out,
                   int n_rows, int C, int64_t B, const bp::ReduceConsts k) {
  __shared__ uint32_t tile[kChunk][kChunk + 1];  // [entry][digit]
  const int r = blockIdx.x;
  const int64_t b = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool live = b < B;
  uint32_t acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) acc[d] = 0;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    const bool full = nc == kChunk;  // uniform over the block
    const uint32_t* xr = x + (static_cast<int64_t>(r) * C + c0) * B + b;
    // a full chunk's witness words first, all 32 loads in flight at once
    // and overlapping the staging of the fold planes
    uint32_t xv[kChunk];
    if (full) {
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc)
        xv[cc] = live ? __ldg(xr + static_cast<int64_t>(cc) * B) : 0u;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kChunk * 32; t += kThreads) {
      const int d = t / kChunk, cc = t % kChunk;
      tile[cc][d] =
          cc < nc ? __ldg(F + (static_cast<int64_t>(d) * n_rows + r) * C + c0 + cc)
                  : 0u;
    }
    __syncthreads();
    if (full) {
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc) {
#pragma unroll
        for (int d = 0; d < 32; ++d) acc[d] += tile[cc][d] * xv[cc];
      }
    } else if (live) {  // the last, partial chunk (and C < 32)
      for (int cc = 0; cc < nc; ++cc) {
        const uint32_t v = __ldg(xr + static_cast<int64_t>(cc) * B);
#pragma unroll
        for (int d = 0; d < 32; ++d) acc[d] += tile[cc][d] * v;
      }
    }
  }
  if (!live) return;
  if constexpr (kCanonical) {
    uint32_t x16[16];
    bp::reduce_digits(acc, k, x16);
#pragma unroll
    for (int l = 0; l < 16; ++l)
      out[(static_cast<int64_t>(l) * n_rows + r) * B + b] = x16[l];
  } else {
    uint32_t x17[17];
    bp::semi_reduce(acc, k.f, x17);
#pragma unroll
    for (int l = 0; l < 17; ++l)
      out[(static_cast<int64_t>(l) * n_rows + r) * B + b] = x17[l];
  }
}

}  // namespace

// canonical = 0: the semi output (17 limbs); 1: the canonical output (16).
extern "C" int bp_fold_matvec(const uint32_t* x, const uint32_t* F,
                              uint32_t* out, int n_rows, int C, int64_t B,
                              int canonical, const uint32_t* consts_host,
                              void* stream) {
  const bp::ReduceConsts k = bp::load_reduce_consts(consts_host);
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>((B + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (canonical)
    fold_matvec_kernel<true><<<grid, kThreads, 0, s>>>(x, F, out, n_rows, C, B, k);
  else
    fold_matvec_kernel<false><<<grid, kThreads, 0, s>>>(x, F, out, n_rows, C, B, k);
  return static_cast<int>(cudaGetLastError());
}
