// Bucket matvec with a static 8-bit fold matrix: the field-exact rows of
// the bits form (x = witness bits) and every row of the fused limbs form
// (x = witness digits), with the semi-reduced or the canonical output.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py make_fold_matvec_bucket,
// as reached through make_bits_matvec_bucket(..., out_form="semi" or
// "canonical") and make_limbs_matvec_bucket(..., out_form="semi" or
// "canonical"): all four instantiations <kBits, kCanonical>.
//
// Function. For ELL row r of a bucket with K entries (column table
// cols[r, e], −1 for an empty entry) and every instance b, the digit sums
// acc[d] = Σ_c F[r, d, c]·x[r, c, b] over the contraction column c, where
//   * digits (limbs form): c = 32e + j, x = digit j of witness slot
//     cols[r, e], read from zt u32[S, 16, B] (16-bit limb l gives digits
//     2l and 2l + 1);
//   * bits: c = e, x = bit b % 32 of word b / 32 of slot cols[r, e], read
//     from the packed slot-major words vals_p u32[S, B/32];
// and an empty entry gives x = 0. F u8[n_rows, 32, Cp] holds the 8-bit
// fold planes (a coefficient's digits for bits, digit d of c·2^(8j) mod p
// for digits), K-major, Cp = C rounded up to 32 and zero padded. The sums
// are exact in uint32 (the wrapper holds C·255² < 2^32) and reduce to 17
// semi limbs (field_pallas._semi_reduce_rows, bit-identical to the TPU
// kernel) or 16 canonical limbs (the TPU's _reduce_rows; a canonical
// residue is unique, so its bits too). Output u32[17 or 16, n_rows, B].
// The canonical output takes every odd p < 2^256 (the fields below 250
// bits, whose checks go canonical, and the others alike).
//
// Design. A block owns one row and 64 instances; its 4 warps each own 16
// instances × all 32 digits. Per row the product is D[64, 32] = X[64, C]·
// F^T[C, 32] on the int8 tensor cores (mma.sync m16n8k32, u8 × u8 → s32),
// one k-step per 32 contraction columns: one ELL entry of digits, or 32
// entries of bits. The block gathers its own x: a cp.async ring of three
// stages (four k-steps each) copies, per entry, the slot's 16 limb rows
// (or its packed words) and the fold planes' 1 KB tile straight from
// global memory into shared memory while the warps run the stage before,
// so no gathered copy of the witness exists in device memory. The A
// fragments are formed in registers from the staged words (a byte permute
// of two limbs, or bit extraction), the B fragments read the staged fold
// tile (16-byte chunks swizzled: conflict-free reads). Each stage's s32
// partial sums (< 4·32·255² < 2^31) are added into uint32 sums, so
// exactness does not depend on how the integer mma treats overflow. The
// epilogue transposes the mma fragments through shared memory and runs
// bp::semi_reduce, or the word tail bp::reduce_digits_canonical (a
// uniform switch on the field's word count W: a fold of the digit sums'
// words at and above W, one 64-bit quotient estimate and two conditional
// subtracts, where the TPU runs 266 − NUM_BITS shift-subtract steps, 202
// for Goldilocks), per (row, instance).
//
// Empty entries are not read: a block first finds its row's extent (last
// live entry + 1; the ELL layout front-packs real entries), so the rows
// that pad a segment to 8 load nothing and write zeros, which is what both
// reductions give for zero sums and what the plain version writes. Blocks
// of one row are adjacent in the grid, so the row's fold planes are read
// from HBM about once and from L2 after.
//
// What bounds it on the card: bytes. Each live entry reads 64 B of limbs
// (4 B of bits) an instance; the tensor cores do 64 int8 operations a byte
// of x, far below their ~590 operations a byte of HBM.
#include "field.cuh"

namespace {

constexpr int kTB = 64;                 // instances a block
constexpr int kWarps = 4;               // 16 instances each
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4;               // mma k-steps a stage
constexpr int kStages = 3;              // cp.async ring depth
constexpr int kLimbStride = kTB + 4;    // words a staged limb row (conflict-free A reads)
constexpr int kBitWords = kTB / 32;     // packed words an entry and block
constexpr int kFWords = 32 * 32 / 4;    // a k-step's fold tile: 32 digits × 32 columns
constexpr int kAccStride = 33;          // epilogue transpose row

template <bool kBits>
struct Tile {
  static constexpr int kXWords = kBits ? kSteps * 32 * kBitWords : kSteps * 16 * kLimbStride;
  static constexpr int kStageWords = kXWords + kSteps * kFWords;
  static constexpr int kSmemBytes =
      4 * (kStages * kStageWords > kTB * kAccStride ? kStages * kStageWords : kTB * kAccStride);
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A·B for a 16×32 u8 A (row-major) and a 32×8 u8 B (column-major).
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w: zt u32[S, 16, B] (digits) or vals_p u32[S, row_words] (bits);
// row_words: words of one limb row of zt (B) or of one slot (B / 32).
// vec: 16-byte copies are aligned (w 16-byte aligned, row_words % 4 == 0).
template <bool kBits, bool kCanonical>
__global__ void __launch_bounds__(kThreads, 3)
fold_matvec_kernel(const uint32_t* __restrict__ w, const int32_t* __restrict__ cols,
                   const uint8_t* __restrict__ F, uint32_t* __restrict__ out, int n_rows, int K,
                   int Cp, int64_t B, int64_t row_words, int vec, const bp::ReduceConsts k) {
  using T = Tile<kBits>;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_len;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t n_tiles = (B + kTB - 1) / kTB;
  const int r = static_cast<int>(blockIdx.x / n_tiles);
  const int64_t b0 = (blockIdx.x % n_tiles) * kTB;
  const int32_t* crow = cols + static_cast<int64_t>(r) * K;

  // the row's extent: entries past the last live one are not read
  if (tid == 0) s_len = 0;
  __syncthreads();
  int mine = 0;
  for (int e = tid; e < K; e += kThreads)
    if (__ldg(crow + e) >= 0) mine = e + 1;
  if (mine) atomicMax(&s_len, mine);
  __syncthreads();
  const int len = s_len;
  if (len == 0) {  // a padding row: both reductions of zero sums are zero
    const int n_out = kCanonical ? 16 : 17;
    for (int q = tid; q < n_out * kTB; q += kThreads) {
      const int l = q / kTB, i = q % kTB;
      if (b0 + i < B) out[(static_cast<int64_t>(l) * n_rows + r) * B + b0 + i] = 0u;
    }
    return;
  }
  const int n_k = kBits ? (len + 31) / 32 : len;  // k-steps
  const int n_st = (n_k + kSteps - 1) / kSteps;

  auto load_stage = [&](int st) {
    uint32_t* xs = smem + (st % kStages) * T::kStageWords;
    uint8_t* fs = reinterpret_cast<uint8_t*>(xs + T::kXWords);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int kk = st * kSteps + ks;
      if (kk >= n_k) break;
      // the fold tile: 32 digit rows of 32 bytes, 16-byte chunks swizzled
      // by bit 2 of the digit so that the B-fragment reads hit 32 banks
      if (tid < 64) {
        const int d = tid >> 1, ch = tid & 1;
        cp16(fs + ks * 1024 + d * 32 + ((ch ^ ((d >> 2) & 1)) << 4),
             F + (static_cast<int64_t>(r) * 32 + d) * Cp + kk * 32 + ch * 16, true);
      }
      if constexpr (kBits) {
        for (int q = tid; q < 32 * kBitWords; q += kThreads) {
          const int ec = q / kBitWords, j = q % kBitWords;
          const int e = kk * 32 + ec;
          const int s = e < K ? __ldg(crow + e) : -1;
          const int64_t wi = b0 / 32 + j;
          const bool ok = s >= 0 && wi < row_words;
          cp4(xs + (ks * 32 + ec) * kBitWords + j, ok ? w + s * row_words + wi : w, ok);
        }
      } else {
        const int s = __ldg(crow + kk);
        for (int q = tid; q < 16 * (kTB / 4); q += kThreads) {
          const int l = q / (kTB / 4), j = (q % (kTB / 4)) * 4;
          uint32_t* dst = xs + (ks * 16 + l) * kLimbStride + j;
          const int64_t b = b0 + j;
          const uint32_t* src = w + (static_cast<int64_t>(max(s, 0)) * 16 + l) * row_words + b;
          if (vec) {
            const bool ok = s >= 0 && b < B;
            cp16(dst, ok ? src : w, ok);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool ok = s >= 0 && b + u < B;
              cp4(dst + u, ok ? src + u : w, ok);
            }
          }
        }
      }
    }
  };

  uint32_t sums[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sums[j][i] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) load_stage(st);
    cp_commit();
  }
  const int i0 = warp * 16 + g, i1 = i0 + 8;  // this thread's fragment rows
  for (int st = 0; st < n_st; ++st) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < n_st) load_stage(st + kStages - 1);
    cp_commit();
    const uint32_t* xs = smem + (st % kStages) * T::kStageWords;
    const uint32_t* fs = xs + T::kXWords;
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    const int nks = min(kSteps, n_k - st * kSteps);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (ks >= nks) break;
      uint32_t a[4];
      if constexpr (kBits) {
        // A[m][c]: bit m of entry c's word; instances 16·warp.. lie in
        // word warp / 2 at bits 16·(warp % 2)..
        const uint32_t* wd = xs + ks * 32 * kBitWords + (warp >> 1);
        const int sh0 = (warp & 1) * 16 + g, sh1 = sh0 + 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t v = wd[(16 * h + 4 * t + i) * kBitWords];
            lo |= ((v >> sh0) & 1u) << (8 * i);
            hi |= ((v >> sh1) & 1u) << (8 * i);
          }
          a[2 * h] = lo;
          a[2 * h + 1] = hi;
        }
      } else {
        // A[m][4t..4t+3] = digits 4t..4t+3 = the low bytes of limbs 2t, 2t+1
        const uint32_t* L = xs + ks * 16 * kLimbStride;
        a[0] = __byte_perm(L[(2 * t) * kLimbStride + i0], L[(2 * t + 1) * kLimbStride + i0], 0x5410);
        a[1] = __byte_perm(L[(2 * t) * kLimbStride + i1], L[(2 * t + 1) * kLimbStride + i1], 0x5410);
        a[2] = __byte_perm(L[(8 + 2 * t) * kLimbStride + i0], L[(9 + 2 * t) * kLimbStride + i0], 0x5410);
        a[3] = __byte_perm(L[(8 + 2 * t) * kLimbStride + i1], L[(9 + 2 * t) * kLimbStride + i1], 0x5410);
      }
      const uint32_t* ft = fs + ks * kFWords;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * j + g, sw = ((d >> 2) & 1) << 2;
        mma_u8(acc[j], a, ft[d * 8 + (sw ^ t)], ft[d * 8 + ((4 ^ sw) | t)]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sums[j][i] += static_cast<uint32_t>(acc[j][i]);
  }
  cp_wait<0>();
  __syncthreads();

  // fragment (g, t) of n-tile j holds digits 8j + 2t, 8j + 2t + 1 of
  // instances i0 (sums[j][0..1]) and i1 (sums[j][2..3])
  uint32_t* sacc = smem;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 8 * j + 2 * t;
    sacc[i0 * kAccStride + d] = sums[j][0];
    sacc[i0 * kAccStride + d + 1] = sums[j][1];
    sacc[i1 * kAccStride + d] = sums[j][2];
    sacc[i1 * kAccStride + d + 1] = sums[j][3];
  }
  __syncthreads();
  if (tid >= kTB || b0 + tid >= B) return;
  const int64_t b = b0 + tid;
  uint32_t acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) acc[d] = sacc[tid * kAccStride + d];
  if constexpr (kCanonical) {
    uint32_t x16[16];
    bp::reduce_digits_canonical(acc, k.c, x16);
#pragma unroll
    for (int l = 0; l < 16; ++l) out[(static_cast<int64_t>(l) * n_rows + r) * B + b] = x16[l];
  } else {
    uint32_t x17[17];
    bp::semi_reduce(acc, k.f, x17);
#pragma unroll
    for (int l = 0; l < 17; ++l) out[(static_cast<int64_t>(l) * n_rows + r) * B + b] = x17[l];
  }
}

template <bool kBits, bool kCanonical>
int launch(const uint32_t* w, const int32_t* cols, const uint8_t* F, uint32_t* out, int n_rows,
           int K, int Cp, int64_t B, int64_t row_words, int vec, const bp::ReduceConsts& k,
           cudaStream_t s) {
  constexpr int smem = Tile<kBits>::kSmemBytes;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(fold_matvec_kernel<kBits, kCanonical>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int64_t blocks = static_cast<int64_t>(n_rows) * ((B + kTB - 1) / kTB);
  fold_matvec_kernel<kBits, kCanonical><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      w, cols, F, out, n_rows, K, Cp, B, row_words, vec, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits = 1: w is vals_p u32[S, B / 32] (row_words = B / 32); bits = 0: w
// is zt u32[S, 16, B] (row_words = B). canonical = 0: the semi output (17
// limbs); 1: the canonical output (16).
extern "C" int bp_fold_matvec(const uint32_t* w, const int32_t* cols, const uint8_t* F,
                              uint32_t* out, int n_rows, int K, int Cp, int64_t B,
                              int64_t row_words, int bits, int canonical, int vec,
                              const uint32_t* consts_host, void* stream) {
  const bp::ReduceConsts k = bp::load_reduce_consts(consts_host);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (canonical && (k.c.n_words < 1 || k.c.n_words > 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (bits && canonical) return launch<true, true>(w, cols, F, out, n_rows, K, Cp, B, row_words, vec, k, s);
  if (bits) return launch<true, false>(w, cols, F, out, n_rows, K, Cp, B, row_words, vec, k, s);
  if (canonical) return launch<false, true>(w, cols, F, out, n_rows, K, Cp, B, row_words, vec, k, s);
  return launch<false, false>(w, cols, F, out, n_rows, K, Cp, B, row_words, vec, k, s);
}
