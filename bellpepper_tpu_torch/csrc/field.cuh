// Shared integer helpers of the field kernels. Two families:
//
// * 16-bit limbs (fold_matvec's semi output): carry passes over digit
//   rows and the semi-reduction of matvec digit sums, with uint32_t
//   wraparound exactly as the JAX package's kernels
//   (bellpepper_tpu/backend/field_pallas.py) compute it;
// * 32-bit words (mulcmp, chain, mul, mul_digits, reduce_digits and
//   fold_matvec's canonical output): a field element as little-endian
//   words, every product one 32×32 → 64-bit mul.wide.u32, a multiply-add
//   of rows with carries, the Montgomery reduction and the zero-test of
//   mulcmp, and one word tail for every odd p < 2^256 with W =
//   ceil(NUM_BITS/32) words: the canonical multiply (a fold of the words
//   at and above W by 2^(32·(W+i)) mod p, then the 64-bit
//   quotient-estimate tail canon_words), the canonical reduction of
//   8-bit-basis digit sums (the same fold and tail), and chain's add. The
//   word helpers are templates on W; the launchers pick the instantiation
//   from the field's constants. These give the same canonical residues
//   and the same verdicts as the 16-bit pipeline, not its intermediate
//   integers.
//
// Every helper works on one element whose rows live in registers
// (fixed-size arrays, fully unrolled, every index static).
#pragma once

#include <cstdint>
#include <type_traits>
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

// x − p when that does not borrow, else x (branch-free; p's words past M
// are 0).
template <int N, int M>
static __device__ __forceinline__ void cond_sub_p(uint32_t (&x)[N], const uint32_t (&p)[M]) {
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

// The word tail's constants (field_consts.kernel_consts(field)["chain"],
// for chain, mul, mul_digits, reduce_digits and fold_matvec's canonical
// output): p as 8 words, the fold rows 2^(32·(W+i)) mod p (i < 8; words
// past W are 0), mu = floor(2^(64+s)/p) for s = max(0, NUM_BITS − 28) as
// its low and high words, W = ceil(NUM_BITS/32), and shift = s − 32·b,
// the estimate's offset in its window of words b = max(0, W − 2)...b + 3.
struct ChainConsts {
  uint32_t p[8];
  uint32_t fold[8][8];
  uint32_t mu_lo, mu_hi;
  uint32_t n_words, shift;
};

static inline ChainConsts load_chain_consts(const uint32_t* s) {
  ChainConsts k;
  for (int w = 0; w < 8; ++w) k.p[w] = *s++;
  for (int r = 0; r < 8; ++r)
    for (int w = 0; w < 8; ++w) k.fold[r][w] = *s++;
  k.mu_lo = s[0];
  k.mu_hi = s[1];
  k.n_words = s[2];
  k.shift = s[3];
  return k;
}

// The first W words of an 8-word constant row.
template <int W>
static __device__ __forceinline__ const uint32_t (&low_words(const uint32_t (&row)[8]))[W] {
  return reinterpret_cast<const uint32_t(&)[W]>(row);
}

// Word i of an N-word value, 0 past its end.
template <int I, int N>
static __device__ __forceinline__ uint32_t word_at(const uint32_t (&s)[N]) {
  if constexpr (I < N) return s[I];
  return 0u;
}

// Canonical S mod p of S < 2^36·p in W + 2 words, for any odd p < 2^256
// of W words. h = floor(S/2^s) < 2^(NUM_BITS + 36 − s) ≤ 2^64, read from
// the 128-bit window of words b..b + 3 at bit k.shift < 64; q̂ =
// floor(h·mu/2^64) satisfies q − 2 ≤ q̂ ≤ q for q = floor(S/p) (q − q̂ <
// 2^s/p + h/2^64 + 1 and 2^s/p < 2^-27, or 1/p at s = 0), so S − q̂·p <
// 3p, computed modulo 2^(32·(W+1)), and two conditional subtracts of p
// finish. 2W word products and one 64-bit high product. (At W = 8 and a
// 255-bit p: h = S >> 227, mu = floor(2^291/p).)
template <int W>
static __device__ __forceinline__ void canon_words(const uint32_t (&s)[W + 2], const ChainConsts& k,
                                                   uint32_t (&out)[W]) {
  constexpr int b = W >= 2 ? W - 2 : 0;
  const uint64_t lo = word_at<b>(s) | (static_cast<uint64_t>(word_at<b + 1>(s)) << 32);
  const uint64_t hi = word_at<b + 2>(s) | (static_cast<uint64_t>(word_at<b + 3>(s)) << 32);
  const uint64_t h = (lo >> k.shift) | ((hi << 1) << (63 - k.shift));
  const uint64_t q = __umul64hi(h, (static_cast<uint64_t>(k.mu_hi) << 32) | k.mu_lo);
  const uint32_t (&p)[W] = low_words<W>(k.p);
  uint32_t qp[W + 1];  // q̂·p modulo 2^(32·(W+1))
#pragma unroll
  for (int i = 0; i <= W; ++i) qp[i] = 0;
  qp[W] = mac_row(qp, 0, static_cast<uint32_t>(q), p);
  mac_row(qp, 1, static_cast<uint32_t>(q >> 32), p);
  uint32_t sw[W + 1], x[W + 1];
#pragma unroll
  for (int i = 0; i <= W; ++i) sw[i] = s[i];
  sub_words(sw, qp, x);
  cond_sub_p(x, p);
  cond_sub_p(x, p);
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = x[i];
}

// s += v·fold[i] for the W-word fold row i, the carry passed into s[W] and
// s[W + 1].
template <int W>
static __device__ __forceinline__ void fold_word(uint32_t (&s)[W + 2], uint32_t v, const ChainConsts& k,
                                                 int i) {
  const uint32_t carry = mac_row(s, 0, v, low_words<W>(k.fold[i]));
  const uint64_t u = static_cast<uint64_t>(s[W]) + carry;
  s[W] = static_cast<uint32_t>(u);
  s[W + 1] += static_cast<uint32_t>(u >> 32);
}

// Canonical a·b mod p of a WA-word a < 2^(32·WA) and a canonical W-word b
// (chain takes canonical operands, WA = W; mul and mul_digits also take a
// raw witness value a in [p, 2^256), WA = 8). T = a·b (WA + W words); S =
// T mod 2^(32W) + Σ_i T[W+i]·fold[i] < 2^(32W) + WA·2^32·p ≤ 9·2^32·p
// (2^(32W) ≤ 2^32·p as p ≥ 2^(32(W−1))), in W + 2 words; then
// canon_words. 2·WA·W + 2W word products (144 at W = WA = 8, against the
// 136 a Montgomery multiply needs).
template <int W, int WA>
static __device__ __forceinline__ void mulmod_words(const uint32_t (&a)[WA], const uint32_t (&b)[W],
                                                    const ChainConsts& k, uint32_t (&out)[W]) {
  uint32_t t[WA + W];
#pragma unroll
  for (int i = 0; i < WA + W; ++i) t[i] = 0;
  // operand scanning: row i's carry lands on t[i + W], which no earlier row
  // has written
#pragma unroll
  for (int i = 0; i < WA; ++i) t[i + W] = mac_row(t, i, a[i], b);
  uint32_t s[W + 2];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = t[i];
  s[W] = s[W + 1] = 0;
#pragma unroll
  for (int i = 0; i < WA; ++i) fold_word<W>(s, t[W + i], k, i);
  canon_words<W>(s, k, out);
}

// Canonical V mod p of a 9-word V < 2^288: words W..8 fold by the fold
// rows, S < 2^(32W) + (9 − W)·2^32·p < 2^36·p; then canon_words.
template <int W>
static __device__ __forceinline__ void reduce_words9(const uint32_t (&v)[9], const ChainConsts& k,
                                                     uint32_t (&out)[W]) {
  uint32_t s[W + 2];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = v[i];
  s[W] = s[W + 1] = 0;
#pragma unroll
  for (int j = W; j < 9; ++j) fold_word<W>(s, v[j], k, j - W);
  canon_words<W>(s, k, out);
}

// Canonical V mod p of V = Σ_j d[j]·2^(8j), 32 digit sums d[j] < 2^32
// (the 8-bit basis of the matvec row sums). Four sums make a word: v_i =
// d[4i] + d[4i+1]·2^8 + d[4i+2]·2^16 + d[4i+3]·2^24 + the carry of
// v_(i−1), each below 2^57 in 64 bits, its high half the next carry; V <
// 2^32·2^248·256/255 < 2^281, 9 words, v_8 < 2^25; then reduce_words9.
// kFold8 = false (W = 8 and NUM_BITS ≥ 245, shift ≥ 25, the host checks)
// skips the fold of v_8: V < 2^281 ≤ 2^(s + 64) already gives h < 2^64,
// and the canonical residue is the same.
template <int W, bool kFold8 = true>
static __device__ __forceinline__ void reduce_digit_words(const uint32_t (&d)[32], const ChainConsts& k,
                                                          uint32_t (&out)[W]) {
  static_assert(kFold8 || W == 8, "only an 8-word field may skip the fold");
  uint32_t v[9];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t w = carry + d[4 * i] + (static_cast<uint64_t>(d[4 * i + 1]) << 8) +
                       (static_cast<uint64_t>(d[4 * i + 2]) << 16) + (static_cast<uint64_t>(d[4 * i + 3]) << 24);
    v[i] = static_cast<uint32_t>(w);
    carry = w >> 32;
  }
  v[8] = static_cast<uint32_t>(carry);
  if constexpr (kFold8) {
    reduce_words9<W>(v, k, out);
  } else {
    uint32_t s[W + 2];  // W = 8: V's 9 words and a zero
#pragma unroll
    for (int i = 0; i < 9; ++i) s[i] = v[i];
    s[9] = 0;
    canon_words<W>(s, k, out);
  }
}

// Canonical a + b mod p: a (W + 1)-word sum below 2p, one conditional
// subtract.
template <int W>
static __device__ __forceinline__ void addmod_words(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                                    const ChainConsts& k, uint32_t (&out)[W]) {
  uint32_t s[W + 1];
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t u = static_cast<uint64_t>(a[i]) + b[i] + carry;
    s[i] = static_cast<uint32_t>(u);
    carry = static_cast<uint32_t>(u >> 32);
  }
  s[W] = carry;
  cond_sub_p(s, low_words<W>(k.p));
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = s[i];
}

// The fold matvec's constants (field_consts.kernel_consts(field)
// ["reduce"]): the semi-reduction's fold rows, then the word tail's.
struct ReduceConsts {
  SemiFold f;
  ChainConsts c;
};

static inline ReduceConsts load_reduce_consts(const uint32_t* s) {
  ReduceConsts k;
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 32; ++l) k.f.fold[i][l] = *s++;
  k.c = load_chain_consts(s);
  return k;
}

// W canonical words → 16 limbs (limbs past 2W are 0).
template <int W>
static __device__ __forceinline__ void words_to_limbs(const uint32_t (&r)[W], uint32_t (&out)[16]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t x = w < W ? r[w < W ? w : 0] : 0u;
    out[2 * w] = x & 0xFFFFu;
    out[2 * w + 1] = x >> 16;
  }
}

// The fold matvec's canonical output for W words: the TPU's _reduce_rows
// first carries the 32 digit sums to 8-bit digits in uint32 (carry8), which
// wraps where a sum near 2^32 meets a carry (the K = 2,064 bound with
// every digit 255); its folds and carries after that are exact. So the
// carried 36 digits' value V < 2^288, as 9 words, mod p (reduce_words9)
// is its canonical output.
template <int W>
static __device__ __forceinline__ void digit_limbs(const uint32_t (&acc)[32], const ChainConsts& k,
                                                   uint32_t (&out)[16]) {
  uint32_t d[36];
  carry8<32, 36>(acc, d);
  uint32_t v[9], r[W];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = d[4 * i] | (d[4 * i + 1] << 8) | (d[4 * i + 2] << 16) | (d[4 * i + 3] << 24);
  reduce_words9<W>(v, k, r);
  words_to_limbs(r, out);
}

// 32 digit sums (8-bit basis, each < 2^32) → 16 canonical limbs, the
// TPU's _reduce_rows bits: digit_limbs at the field's W (a uniform
// branch).
static __device__ __forceinline__ void reduce_digits_canonical(const uint32_t (&d)[32], const ChainConsts& k,
                                                               uint32_t (&out)[16]) {
  switch (k.n_words) {
    case 1: digit_limbs<1>(d, k, out); break;
    case 2: digit_limbs<2>(d, k, out); break;
    case 3: digit_limbs<3>(d, k, out); break;
    case 4: digit_limbs<4>(d, k, out); break;
    case 5: digit_limbs<5>(d, k, out); break;
    case 6: digit_limbs<6>(d, k, out); break;
    case 7: digit_limbs<7>(d, k, out); break;
    default: digit_limbs<8>(d, k, out); break;
  }
}

// Host: f(std::integral_constant<int, W>{}) for the field's word count W
// (ChainConsts::n_words, 1..8), f's return value, or cudaErrorInvalidValue.
template <class F>
static inline int with_words(uint32_t n_words, F&& f) {
  switch (n_words) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bp
