// Canonical reduction of digit sums: out = Σ_d d_sum[d]·2^(8d) mod p.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py PallasFieldOps.
// reduce_digits (_reduce_kernel: _reduce_rows).
//
// Input u32[32, N]: per element 32 sums of 8-bit-basis digits, each below
// 2^24 (the non-fused limbs check's ELL row sums of mul_digits outputs;
// the wrapper does not see the sums, so the caller holds the bound, as
// layout._assert_row_density does). Output u32[16, N] canonical limbs,
// bit-identical to the TPU kernel (bp::reduce_digits in field.cuh).
//
// Design: one thread per element, coalesced along N; the 32 sums and every
// temporary live in registers, the fold rows and the shift-subtract moduli
// arrive as one kernel parameter (uniform constant-bank operands).
//
// What bounds it on the card: bytes. 192 bytes an element against a
// reduction of a 10-word value (the function's products), which the card
// does in less time than it moves the bytes.
#include "field.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
reduce_digits_kernel(const uint32_t* __restrict__ d, uint32_t* __restrict__ out,
                     int64_t n, const bp::ReduceConsts k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[32], r[16];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = __ldg(d + j * n + i);
  bp::reduce_digits(acc, k, r);
#pragma unroll
  for (int l = 0; l < 16; ++l) out[l * n + i] = r[l];
}

}  // namespace

extern "C" int bp_reduce_digits(const uint32_t* d, uint32_t* out, int64_t n,
                                const uint32_t* consts_host, void* stream) {
  const bp::ReduceConsts k = bp::load_reduce_consts(consts_host);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  reduce_digits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(d, out, n, k);
  return static_cast<int>(cudaGetLastError());
}
