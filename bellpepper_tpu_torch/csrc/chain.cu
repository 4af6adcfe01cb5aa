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
// modular multiply gives the TPU kernel's bits.
//
// What bounds it on the card: latency. Each instance is one dependent
// chain of d·n_reps ops, and config 1 has only 8,192 instances, 256 warps
// for 132 SMs: one warp an SM sub-partition at most, so nearly every
// instruction of the chain waits for the one before, and the time per
// step, not the bytes, sets the kernel's time.
//
// Design: one thread per instance in blocks of 32 threads, so that the
// 256 warps spread over every SM. The running value stays in registers as
// 8 32-bit words, and each fmul is bp::mulmod_words (field.cuh): 64
// mul.wide.u32 products, a fold of the 8 high words by 2^(32·(8+i)) mod p
// (64 more), a 64-bit quotient estimate and 16 more:
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

// 16 limb rows of instance i → 8 words
static __device__ __forceinline__ void load_words(const uint32_t* __restrict__ src, int64_t n,
                                                  int64_t i, uint32_t (&w)[8]) {
  uint32_t l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) l[r] = __ldg(src + r * n + i);
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = bp::join16(l[2 * k], l[2 * k + 1]);
}

static __device__ __forceinline__ void operand(unsigned src, const uint32_t (&cur)[8],
                                               const uint32_t* __restrict__ ext, int64_t n,
                                               int64_t i, uint32_t (&out)[8]) {
  if (src == kPrev) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = cur[k];
  } else {
    load_words(ext + static_cast<int64_t>(src) * 16 * n, n, i, out);
  }
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ ext,
             uint32_t* __restrict__ out, int64_t n, int n_reps, int n_desc,
             uint64_t fmul_mask, uint64_t a_src, uint64_t b_src,
             const bp::ChainConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t cur[8];
  load_words(x0, n, i, cur);
  uint32_t* o = out + i;
  for (int r = 0; r < n_reps; ++r) {
    for (int j = 0; j < n_desc; ++j) {
      uint32_t a[8], b[8];
      operand(static_cast<unsigned>(a_src >> (8 * j)) & 0xFFu, cur, ext, n, i, a);
      operand(static_cast<unsigned>(b_src >> (8 * j)) & 0xFFu, cur, ext, n, i, b);
      if ((fmul_mask >> j) & 1u)
        bp::mulmod_words(a, b, k, cur);
      else
        bp::addmod_words(a, b, k, cur);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        o[(2 * w) * n] = cur[w] & 0xFFFFu;
        o[(2 * w + 1) * n] = cur[w] >> 16;
      }
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
  chain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, ext, out, n, n_reps, n_desc, fmul_mask, a_src, b_src, k);
  return static_cast<int>(cudaGetLastError());
}
