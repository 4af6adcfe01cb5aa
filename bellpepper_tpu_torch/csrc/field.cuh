// Shared integer helpers of the field kernels. Two families:
//
// * 16-bit limbs (fold_matvec): carry passes over digit rows, the
//   semi-reduction and the canonical reduction of matvec digit sums, with
//   uint32_t wraparound exactly as the JAX package's kernels
//   (bellpepper_tpu/backend/field_pallas.py) compute it;
// * 32-bit words (mulcmp, chain, mul, mul_digits, reduce_digits): a field
//   element as 8 or 9 little-endian words, every product one 32×32 →
//   64-bit mul.wide.u32, a multiply-add of rows with carries, the
//   Montgomery reduction and the zero-test of mulcmp, the canonical
//   multiply (a fold of the high words by 2^(32·(8+i)) mod p, then the
//   64-bit quotient-estimate tail canon_words), the canonical reduction
//   of 8-bit-basis digit sums (the same tail), and chain's add. These give
//   the same canonical residues and the same verdicts as the 16-bit
//   pipeline, not its intermediate integers.
//
// Every helper works on one element whose rows live in registers
// (fixed-size arrays, fully unrolled, every index static).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bp {

// carry over 8-bit digits: out[i] = (in[i] + carry) & 0xFF, positions past
// N_IN take the carry alone; the final carry drops (field_pallas._carry8_rows).
template <int N_IN, int N_OUT>
static __device__ __forceinline__ void carry8(const uint32_t (&in)[N_IN],
                                              uint32_t (&out)[N_OUT]) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) {
    const uint32_t tot = (i < N_IN ? in[i] : 0u) + carry;
    out[i] = tot & 0xFFu;
    carry = tot >> 8;
  }
}

// fold rows 0..3 of the 8-bit basis: limbs8(2^(8·(32+i)) mod p).
struct SemiFold {
  uint32_t fold[4][32];
};

// 32 digit sums (8-bit basis, each < 2^32) → 17 semi-reduced 16-bit limbs,
// a value < 2^265 congruent mod p (field_pallas._semi_reduce_rows):
// carry to 36 positions, fold positions 32..35, carry, join digit pairs.
static __device__ __forceinline__ void semi_reduce(const uint32_t (&acc)[32],
                                                   const SemiFold& f,
                                                   uint32_t (&x17)[17]) {
  uint32_t d[36];
  carry8<32, 36>(acc, d);
  uint32_t out[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) out[l] = d[l];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int l = 0; l < 32; ++l) out[l] += d[32 + i] * f.fold[i][l];
  }
  uint32_t d2[34];
  carry8<32, 34>(out, d2);
#pragma unroll
  for (int i = 0; i < 16; ++i) x17[i] = d2[2 * i] | (d2[2 * i + 1] << 8);
  x17[16] = d2[32] | (d2[33] << 8);
}

// x − ps when the subtraction does not borrow, else x (branch-free).
template <int N>
static __device__ __forceinline__ void cond_sub(uint32_t (&x)[N],
                                                const uint32_t (&ps)[N]) {
  uint32_t diff[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t d = x[i] - ps[i] - borrow;
    borrow = d >> 31;
    diff[i] = d & 0xFFFFu;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = borrow ? x[i] : diff[i];
}

// The canonical digit reduction's constants, in the layout of
// field_consts.kernel_consts(field)["reduce"]: the semi-reduction's fold
// rows, then the shift-subtract moduli p·2^k (k = n_ps − 1 … 0, high
// first) as 17 limbs, padded to kMaxShifts rows, and their count
// 266 − NUM_BITS.
constexpr int kMaxShifts = 16;  // NUM_BITS >= 250
struct ReduceConsts {
  SemiFold f;
  uint32_t ps[kMaxShifts][17];
  uint32_t n_ps;
};

static inline ReduceConsts load_reduce_consts(const uint32_t* s) {
  ReduceConsts k;
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 32; ++l) k.f.fold[i][l] = *s++;
  for (int r = 0; r < kMaxShifts; ++r)
    for (int l = 0; l < 17; ++l) k.ps[r][l] = *s++;
  k.n_ps = *s;
  return k;
}

// 32 digit sums (8-bit basis, each < 2^32) → 16 canonical limbs
// (field_pallas._reduce_rows; fold_matvec's canonical output, while the
// reduce_digits kernel takes reduce_digit_words): carry → fold → carry →
// fold → carry → join16 → the shift-subtract chain (_chain_rows). The
// TPU carries to 66 positions and folds all 34 rows past position 31; for
// sums below 2^32 every position past 34 is zero after the first carry
// and past 33 after the second, so folding rows 0..3 and then 0..1 adds
// the same (nothing else), and the bits are the TPU kernel's.
static __device__ __forceinline__ void reduce_digits(const uint32_t (&acc)[32],
                                                     const ReduceConsts& k,
                                                     uint32_t (&out)[16]) {
  uint32_t d[36];
  carry8<32, 36>(acc, d);
  uint32_t f1[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) f1[l] = d[l];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int l = 0; l < 32; ++l) f1[l] += d[32 + i] * k.f.fold[i][l];
  }
  uint32_t e[34];
  carry8<32, 34>(f1, e);
  uint32_t f2[32];
#pragma unroll
  for (int l = 0; l < 32; ++l)
    f2[l] = e[l] + e[32] * k.f.fold[0][l] + e[33] * k.f.fold[1][l];
  uint32_t g[34];
  carry8<32, 34>(f2, g);
  uint32_t x[17];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = g[2 * i] | (g[2 * i + 1] << 8);
  x[16] = g[32] | (g[33] << 8);
#pragma unroll
  for (int s = 0; s < kMaxShifts; ++s)
    if (s < static_cast<int>(k.n_ps)) cond_sub<17>(x, k.ps[s]);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = x[i];
}

// ---------------------------------------------------------------------------
// 32-bit words
// ---------------------------------------------------------------------------

// Two 16-bit limb rows → one word.
static __device__ __forceinline__ uint32_t join16(uint32_t lo, uint32_t hi) {
  return lo | (hi << 16);
}

// r[off + j] += x·y[j] for j < M with the carry passed along; returns the
// carry out of r[off + M − 1]. Each step x·y + r + carry is at most
// (2^32 − 1)² + 2·(2^32 − 1) = 2^64 − 1, so one 64-bit word holds it.
template <int M, int N>
static __device__ __forceinline__ uint32_t mac_row(uint32_t (&r)[N], int off, uint32_t x,
                                                   const uint32_t (&y)[M]) {
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const uint64_t t = static_cast<uint64_t>(x) * y[j] + r[off + j] + carry;
    r[off + j] = static_cast<uint32_t>(t);
    carry = static_cast<uint32_t>(t >> 32);
  }
  return carry;
}

// r = a·b + r: r's low M words hold an addend, its high M words must be 0
// (operand scanning: row i's carry lands on r[i + M], which no earlier row
// has written, and the partial sum stays below 2^(32·(i + M + 1))).
template <int M>
static __device__ __forceinline__ void mad_words(const uint32_t (&a)[M], const uint32_t (&b)[M],
                                                 uint32_t (&r)[2 * M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) r[i + M] = mac_row(r, i, a[i], b);
}

// x − y over N words, and whether it borrowed (y's words past M are 0).
template <int N, int M>
static __device__ __forceinline__ uint32_t sub_words(const uint32_t (&x)[N], const uint32_t (&y)[M],
                                                     uint32_t (&d)[N]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t t = static_cast<uint64_t>(x[k]) - (k < M ? y[k] : 0u) - borrow;
    d[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  return borrow;
}

// x − p when that does not borrow, else x (branch-free).
template <int N>
static __device__ __forceinline__ void cond_sub_p(uint32_t (&x)[N], const uint32_t (&p)[8]) {
  uint32_t d[N];
  const uint32_t borrow = sub_words(x, p, d);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = borrow ? x[k] : d[k];
}

// mulcmp's constants (field_consts.kernel_consts(field)["mulcmp"]): p·2^11
// as 9 words (the borrow-free −c), p as 8 words, and −p^-1 mod 2^32.
struct MulcmpConsts {
  uint32_t p2_11[9];
  uint32_t p[8];
  uint32_t pinv;
};

// 1 iff a·b ≢ c (mod p) for 9-word a, b < 2^266 and c ≤ p·2^11, p < 2^256:
// T = a·b + (p·2^11 − c) in 18 words, then a Montgomery reduction of its 9
// low words, x = (T + m·p)/2^288 with m < 2^288 making the low words zero.
// x ≡ T·2^-288, so T ≡ 0 iff x ≡ 0; x < T/2^288 + p < 2^244 + p < 2p
// (p ≥ 2^249), so x ≡ 0 iff x is 0 or p.
static __device__ __forceinline__ uint32_t mulcmp_words(const uint32_t (&a)[9], const uint32_t (&b)[9],
                                                        const uint32_t (&c)[9], const MulcmpConsts& k) {
  uint32_t negc[9], r[18];
  sub_words(k.p2_11, c, negc);
#pragma unroll
  for (int i = 0; i < 18; ++i) r[i] = i < 9 ? negc[i] : 0u;
  mad_words(a, b, r);
  uint32_t pend = 0;  // the carry owed to r[i + 9]
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const uint32_t m = r[i] * k.pinv;
    const uint32_t carry = mac_row(r, i, m, k.p);
    const uint64_t t = static_cast<uint64_t>(r[i + 8]) + carry + pend;
    r[i + 8] = static_cast<uint32_t>(t);
    pend = static_cast<uint32_t>(t >> 32);
  }
  r[17] += pend;
  uint32_t nz = 0, np = r[17];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    nz |= r[9 + w];
    np |= r[9 + w] ^ k.p[w];
  }
  nz |= r[17];
  return (nz != 0) & (np != 0);
}

// The word multiply's constants (field_consts.kernel_consts(field)["chain"],
// for chain and mul): p as 8 words, the fold rows 2^(32·(8+i)) mod p
// (i < 8), and mu = floor(2^291/p) as its low and high words.
struct ChainConsts {
  uint32_t p[8];
  uint32_t fold[8][8];
  uint32_t mu_lo, mu_hi;
};

static inline ChainConsts load_chain_consts(const uint32_t* s) {
  ChainConsts k;
  for (int w = 0; w < 8; ++w) k.p[w] = *s++;
  for (int r = 0; r < 8; ++r)
    for (int w = 0; w < 8; ++w) k.fold[r][w] = *s++;
  k.mu_lo = s[0];
  k.mu_hi = s[1];
  return k;
}

// Canonical S mod p of S < 2^291 (10 words), for 2^252 ≤ p < 2^256:
// h = floor(S/2^227) < 2^64 and q̂ = floor(h·mu/2^64) satisfy q − 2 ≤ q̂
// ≤ q for q = floor(S/p) (mu ≥ 2^291/p − 1 and 2^227/p < 2^-25), so
// S − q̂·p < 3p, computed modulo 2^288, and two conditional subtracts of
// p finish. 16 word products and one 64-bit high product.
static __device__ __forceinline__ void canon_words(const uint32_t (&s)[10], const ChainConsts& k,
                                                   uint32_t (&out)[8]) {
  const uint64_t h = (static_cast<uint64_t>(s[9]) << 61) | (static_cast<uint64_t>(s[8]) << 29) | (s[7] >> 3);
  const uint64_t q = __umul64hi(h, (static_cast<uint64_t>(k.mu_hi) << 32) | k.mu_lo);
  uint32_t qp[9];  // q̂·p modulo 2^288
#pragma unroll
  for (int i = 0; i < 9; ++i) qp[i] = 0;
  qp[8] = mac_row(qp, 0, static_cast<uint32_t>(q), k.p);
  mac_row(qp, 1, static_cast<uint32_t>(q >> 32), k.p);
  uint32_t s9[9], x[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) s9[i] = s[i];
  sub_words(s9, qp, x);
  cond_sub_p(x, k.p);
  cond_sub_p(x, k.p);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = x[i];
}

// Canonical a·b mod p of 8-word a, b < 2^256 (chain and mul take canonical
// operands; mul and mul_digits also take a raw witness value a in
// [p, 2^256)), for 2^252 ≤ p < 2^256. T = a·b (16 words); S = T mod
// 2^256 + Σ_i T[8+i]·fold[i] < 2^256 + 8·2^32·p < 2^291 (10 words, the top
// below 8), whatever a and b below 2^256; then canon_words. 64 + 64 + 16
// word products, against the 136 a Montgomery multiply needs.
static __device__ __forceinline__ void mulmod_words(const uint32_t (&a)[8], const uint32_t (&b)[8],
                                                    const ChainConsts& k, uint32_t (&out)[8]) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
  mad_words(a, b, t);
  uint32_t s[10];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = t[i];
  s[8] = s[9] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t carry = mac_row(s, 0, t[8 + i], k.fold[i]);
    const uint64_t u = static_cast<uint64_t>(s[8]) + carry;
    s[8] = static_cast<uint32_t>(u);
    s[9] += static_cast<uint32_t>(u >> 32);
  }
  canon_words(s, k, out);
}

// Canonical V mod p of V = Σ_j d[j]·2^(8j), 32 digit sums d[j] < 2^32
// (the 8-bit basis of the matvec row sums), for 2^252 ≤ p < 2^256. Four
// sums make a word: w_i = d[4i] + d[4i+1]·2^8 + d[4i+2]·2^16 +
// d[4i+3]·2^24 + the carry of w_(i−1), each below 2^57 in 64 bits, its
// high half the next carry. V < 2^32·2^248·256/255 < 2^281, so its 9
// words already meet canon_words' S < 2^291 and no fold is needed (V's
// word 8 is below 2^25).
static __device__ __forceinline__ void reduce_digit_words(const uint32_t (&d)[32], const ChainConsts& k,
                                                          uint32_t (&out)[8]) {
  uint32_t s[10];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t w = carry + d[4 * i] + (static_cast<uint64_t>(d[4 * i + 1]) << 8) +
                       (static_cast<uint64_t>(d[4 * i + 2]) << 16) + (static_cast<uint64_t>(d[4 * i + 3]) << 24);
    s[i] = static_cast<uint32_t>(w);
    carry = w >> 32;
  }
  s[8] = static_cast<uint32_t>(carry);
  s[9] = 0;
  canon_words(s, k, out);
}

// Canonical a + b mod p: a 9-word sum below 2p, one conditional subtract.
static __device__ __forceinline__ void addmod_words(const uint32_t (&a)[8], const uint32_t (&b)[8],
                                                    const ChainConsts& k, uint32_t (&out)[8]) {
  uint32_t s[9];
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t u = static_cast<uint64_t>(a[i]) + b[i] + carry;
    s[i] = static_cast<uint32_t>(u);
    carry = static_cast<uint32_t>(u >> 32);
  }
  s[8] = carry;
  cond_sub_p(s, k.p);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = s[i];
}

}  // namespace bp
