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
// an external index).
//
// Design: one thread per instance. The running value stays in registers
// for the whole chain; an external operand is read from global memory at
// each use (coalesced, and an L1/L2 hit after the first repetition), so
// any number of external operands works with one kernel. The pattern is
// the same for every thread, so its branches are uniform; each step's 16
// limbs are stored limb-major, so neighbouring threads write neighbouring
// words. The TPU kernel's 96-step cap only bounded its VMEM output block;
// this kernel has none.
#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kPrev = 0xFF;

static __device__ __forceinline__ void load_operand(
    unsigned src, const uint32_t (&cur)[16], const uint32_t* __restrict__ ext,
    int64_t n, int64_t i, uint32_t (&out)[16]) {
  if (src == kPrev) {
#pragma unroll
    for (int l = 0; l < 16; ++l) out[l] = cur[l];
  } else {
    const uint32_t* e = ext + static_cast<int64_t>(src) * 16 * n + i;
#pragma unroll
    for (int l = 0; l < 16; ++l) out[l] = __ldg(e + l * n);
  }
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ ext,
             uint32_t* __restrict__ out, int64_t n, int n_reps, int n_desc,
             uint64_t fmul_mask, uint64_t a_src, uint64_t b_src,
             const bp::ModConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t cur[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) cur[l] = __ldg(x0 + l * n + i);
  uint32_t* o = out + i;
  for (int r = 0; r < n_reps; ++r) {
    for (int j = 0; j < n_desc; ++j) {
      uint32_t a[16], b[16];
      load_operand(static_cast<unsigned>(a_src >> (8 * j)) & 0xFFu, cur, ext, n, i, a);
      load_operand(static_cast<unsigned>(b_src >> (8 * j)) & 0xFFu, cur, ext, n, i, b);
      if ((fmul_mask >> j) & 1u)
        bp::mul_canon(a, b, k, cur);
      else
        bp::add_canon(a, b, k, cur);
#pragma unroll
      for (int l = 0; l < 16; ++l) o[l * n] = cur[l];
      o += 16 * n;
    }
  }
}

}  // namespace

extern "C" int bp_chain(const uint32_t* x0, const uint32_t* ext, uint32_t* out,
                        int64_t n, int n_reps, int n_desc, uint64_t fmul_mask,
                        uint64_t a_src, uint64_t b_src, const uint32_t* consts_host,
                        void* stream) {
  const bp::ModConsts k = bp::load_mod_consts(consts_host);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  chain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, ext, out, n, n_reps, n_desc, fmul_mask, a_src, b_src, k);
  return static_cast<int>(cudaGetLastError());
}
