// Fused periodic field chain: n_reps repetitions of d field ops (fmul or
// fadd), each operand the previous step's output or an external operand,
// every step's canonical output written in chain order.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py make_chain_kernel
// (the x = (x·b + a)² witness chain of BASELINE config 1).
//
// Inputs x0 u32[16, N] (the chain's entry) and ext u32[n_ext·16, N]
// (external operand k is rows 16k..16k+15), canonical limb-major; output
// u32[n_reps·d·16, N]. The pattern arrives as three 64-bit arguments, one
// byte a position: fmul_mask bit j is set when op j is an fmul, and byte j
// of a_src and b_src names its operands (0xFF: the previous output, else
// an external index). The outputs are canonical residues, so any exact
// modular multiply gives the TPU kernel's bits. Every odd p < 2^256: the
// kernel is instantiated for each word count W = ceil(NUM_BITS/32) and
// reads the 2W low limbs of each canonical operand (the limbs past 2W of
// every output are 0).
//
// What bounds it on the card: latency. Each instance is one dependent
// chain of d·n_reps ops, and config 1 has only 8,192 instances, 256 warps
// for 132 SMs: one warp an SM sub-partition at most, so nearly every
// instruction of the chain waits for the one before, and the time per
// step, not the bytes, sets the kernel's time.
//
// Design: one thread per instance in blocks of 32 threads, so that the
// 256 warps spread over every SM. The running value stays in registers as
// W 32-bit words, and each fmul is bp::mulmod_words (field.cuh): at W = 8
// 64 mul.wide.u32 products, a fold of the 8 high words by 2^(32·(8+i))
// mod p (64 more), a 64-bit quotient estimate and 16 more (W² + W² + 2W
// in general):
// about a third of the instructions of the TPU's 16-bit-limb multiply (834
// multiplies), and a shorter dependent path.
// An external operand is read at each use (coalesced, an L1 hit after the
// first repetition), so any number of them works with one kernel; the
// pattern is the same for every thread, so its branches are uniform. Each
// step's 16 limbs are stored limb-major: neighbouring threads write
// neighbouring words.
#include "field.cuh"

namespace {

constexpr int kThreads = 32;
constexpr unsigned kPrev = 0xFF;

// 2W limb rows of instance i → W words
template <int W>
static __device__ __forceinline__ void load_words(const uint32_t* __restrict__ src, int64_t n,
                                                  int64_t i, uint32_t (&w)[W]) {
  uint32_t l[2 * W];
#pragma unroll
  for (int r = 0; r < 2 * W; ++r) l[r] = __ldg(src + r * n + i);
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = bp::join16(l[2 * k], l[2 * k + 1]);
}

template <int W>
static __device__ __forceinline__ void operand(unsigned src, const uint32_t (&cur)[W],
                                               const uint32_t* __restrict__ ext, int64_t n,
                                               int64_t i, uint32_t (&out)[W]) {
  if (src == kPrev) {
#pragma unroll
    for (int k = 0; k < W; ++k) out[k] = cur[k];
  } else {
    load_words<W>(ext + static_cast<int64_t>(src) * 16 * n, n, i, out);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ ext,
             uint32_t* __restrict__ out, int64_t n, int n_reps, int n_desc,
             uint64_t fmul_mask, uint64_t a_src, uint64_t b_src,
             const bp::ChainConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t cur[W];
  load_words<W>(x0, n, i, cur);
  uint32_t* o = out + i;
  for (int r = 0; r < n_reps; ++r) {
    for (int j = 0; j < n_desc; ++j) {
      uint32_t a[W], b[W];
      operand<W>(static_cast<unsigned>(a_src >> (8 * j)) & 0xFFu, cur, ext, n, i, a);
      operand<W>(static_cast<unsigned>(b_src >> (8 * j)) & 0xFFu, cur, ext, n, i, b);
      if ((fmul_mask >> j) & 1u)
        bp::mulmod_words<W, W>(a, b, k, cur);
      else
        bp::addmod_words<W>(a, b, k, cur);
      uint32_t limbs[16];
      bp::words_to_limbs(cur, limbs);
#pragma unroll
      for (int l = 0; l < 16; ++l) o[l * n] = limbs[l];
      o += 16 * n;
    }
  }
}

}  // namespace

extern "C" int bp_chain(const uint32_t* x0, const uint32_t* ext, uint32_t* out,
                        int64_t n, int n_reps, int n_desc, uint64_t fmul_mask,
                        uint64_t a_src, uint64_t b_src, const uint32_t* consts_host,
                        void* stream) {
  const bp::ChainConsts k = bp::load_chain_consts(consts_host);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  return bp::with_words(k.n_words, [&](auto w) {
    chain_kernel<decltype(w)::value><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x0, ext, out, n, n_reps, n_desc, fmul_mask, a_src, b_src, k);
    return static_cast<int>(cudaGetLastError());
  });
}
