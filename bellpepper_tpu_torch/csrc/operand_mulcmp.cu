// The product rows of the mixed and limbs checks in one pass: for each
// (row, instance) column, assemble the operands a, b, c of the row from
// its ±1 terms and compare a·b ≡ c (mod p) with mulcmp's arithmetic.
//
// Replaces: no Pallas kernel. The reference assembles these operands in
// jnp (bellpepper_tpu/backend/matvec.py:1686 _operand_spec and the
// trivial rows' gathers, which XLA fuses) and feeds them to make_mulcmp
// (field_pallas.py:1009); the port did the same assembly as eager int64
// passes over [n, 17, B] operands (check_common._Operand.assemble), then
// a transposing copy and csrc/mulcmp.cu.
//
// Inputs: a descriptor table int32[n, 18], per row and operand (A, B, C)
// six words: flags (bit t on, bit 4 + t negated, for the field terms t =
// 0, 1 and the u32 terms t = 2, 3), a constant's id in consts u32[K, 9]
// (row 0 is zero), two indices into the limb buffer flimbs u32[F, 16, B]
// (canonical 16-bit limbs) and two into the u32 values vals u32[S, B]
// (absent where no row has a u32 term). An operand is const + Σ ±term, a
// negated term p − x, taken modulo 2^272 as the eager route's 17 carried
// limbs take it: below 3p < 2^266 for canonical terms (a constant < p and
// at most two terms each ≤ max(p, 2^32)), so within mulcmp's a, b < 2^266
// and c ≤ p·2^11. Output bool[n, B]: 1 where a·b ≢ c (mod p).
//
// What bounds it on the card: the bytes of the distinct limb elements
// the rows read, 64 a field element and instance (16 limbs of one int32
// word each) and 4 a u32 value, plus the byte a column writes, and the
// products of mulcmp's arithmetic; the eager route wrote and read back
// int64 operands of 136 bytes a column many times over.
//
// Design: a warp takes 32 consecutive instances of one row, so each limb
// plane flimbs[f, l, b0 : b0 + 32] is one coalesced 128-byte load and the
// row's term counts are the same for the whole warp (uniform branches).
// Consecutive warps take the next instances, then the next row, so rows
// that share a variable (MinRoot's sq in rows 3i and 3i + 1) read it from
// L1 or L2. Each operand's loads are issued together, then the operand
// is assembled before the next one's loads: 88 registers, against 168
// with all three operands' loads first, and 3.0 ms against 4.2 ms at
// MinRoot's chunk of 196,608 rows × 256 instances (the occupancy bought
// outweighs the loads left in flight; blocks of 8 warps were slower).
// Limb pairs join into 32-bit words, a negated term is p − x in 9 words,
// the sum drops its carries past 2^288 and keeps 16 bits of word 8, and
// bp::mulcmp_words (field.cuh) makes the compare: about 700 instructions
// a column, so the products bound it (about 1.0 ms at MinRoot's chunk,
// the bytes about 1.0 ms too). Offsets are 64-bit (f·16·B passes 2^31 at
// large batches).
#include "field.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDescWords = 18;  // 3 operands × (flags, const id, 2 field indices, 2 u32 indices)

// acc += x over N words, the last carry dropped.
template <int N>
__device__ __forceinline__ void add_words(uint32_t (&acc)[N], const uint32_t (&x)[N]) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t t = static_cast<uint64_t>(acc[i]) + x[i] + carry;
    acc[i] = static_cast<uint32_t>(t);
    carry = static_cast<uint32_t>(t >> 32);
  }
}

// acc += x, or acc += p − x (modulo 2^288) where neg.
__device__ __forceinline__ void add_term(uint32_t (&acc)[9], const uint32_t (&x)[9], bool neg,
                                         const uint32_t (&p9)[9]) {
  if (neg) {
    uint32_t d[9];
    bp::sub_words(p9, x, d);
    add_words(acc, d);
  } else {
    add_words(acc, x);
  }
}

__global__ void __launch_bounds__(kThreads)
operand_mulcmp_kernel(const int32_t* __restrict__ desc, const uint32_t* __restrict__ consts,
                      const uint32_t* __restrict__ flimbs, const uint32_t* __restrict__ vals,
                      uint8_t* __restrict__ out, int64_t n, int64_t B, int64_t groups,
                      const bp::MulcmpConsts k) {
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t row = warp / groups;
  const int64_t b = (warp - row * groups) * 32 + (threadIdx.x & 31);
  if (row >= n || b >= B) return;
  const int32_t* d = desc + row * kDescWords;
  uint32_t flags[3], cid[3];
  int64_t idx[3][4];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    flags[o] = static_cast<uint32_t>(__ldg(d + 6 * o));
    cid[o] = static_cast<uint32_t>(__ldg(d + 6 * o + 1));
#pragma unroll
    for (int t = 0; t < 4; ++t) idx[o][t] = __ldg(d + 6 * o + 2 + t);
  }
  uint32_t p9[9];
#pragma unroll
  for (int w = 0; w < 8; ++w) p9[w] = k.p[w];
  p9[8] = 0;
  uint32_t x[3][9];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    // the operand's loads first, all in flight together
    uint32_t fl[2][16], uv[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (flags[o] & (1u << t)) {
        const uint32_t* s = flimbs + idx[o][t] * 16 * B + b;
#pragma unroll
        for (int l = 0; l < 16; ++l) fl[t][l] = __ldg(s + l * B);
      }
      uv[t] = flags[o] & (4u << t) ? __ldg(vals + idx[o][2 + t] * B + b) : 0u;
    }
    if (cid[o]) {
#pragma unroll
      for (int w = 0; w < 9; ++w) x[o][w] = __ldg(consts + 9 * static_cast<int64_t>(cid[o]) + w);
    } else {
#pragma unroll
      for (int w = 0; w < 9; ++w) x[o][w] = 0;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (flags[o] & (1u << t)) {
        uint32_t v[9];
#pragma unroll
        for (int w = 0; w < 8; ++w) v[w] = bp::join16(fl[t][2 * w], fl[t][2 * w + 1]);
        v[8] = 0;
        add_term(x[o], v, flags[o] & (16u << t), p9);
      }
      if (flags[o] & (4u << t)) {
        uint32_t v[9] = {uv[t], 0, 0, 0, 0, 0, 0, 0, 0};
        add_term(x[o], v, flags[o] & (64u << t), p9);
      }
    }
    x[o][8] &= 0xFFFFu;  // the eager route's 17 limbs: modulo 2^272
  }
  out[row * B + b] = static_cast<uint8_t>(bp::mulcmp_words(x[0], x[1], x[2], k));
}

}  // namespace

extern "C" int bp_operand_mulcmp(const int32_t* desc, const uint32_t* consts, const uint32_t* flimbs,
                                 const uint32_t* vals, uint8_t* out, int64_t n, int64_t B,
                                 const uint32_t* consts_host, void* stream) {
  bp::MulcmpConsts k;
  const uint32_t* s = consts_host;
  for (int w = 0; w < 9; ++w) k.p2_11[w] = *s++;
  for (int w = 0; w < 8; ++w) k.p[w] = *s++;
  k.pinv = *s;
  const int64_t groups = (B + 31) / 32;
  const int64_t blocks = (n * groups + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  operand_mulcmp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      desc, consts, flimbs, vals, out, n, B, groups, k);
  return static_cast<int>(cudaGetLastError());
}
