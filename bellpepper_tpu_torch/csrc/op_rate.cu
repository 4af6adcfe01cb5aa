// The card's op-rate probe: R independent rows, K rounds of one op class
// on every element, the rows summed into one output row.
//
// Replaces: benchmarks/probe_vpu_ops.py (the Pallas kernel at :87, the
// TPU VPU probe). The seven op classes and their round bodies are the
// probe's: u32 add v + (v | 1), u32 mul v·(v | 1), u16 mul (v & 0xFFFF)·3,
// shift-and (v >> 3) & 0xFFFF, f32 mul v·v, f32 fma v·v + v, and cvt
// u32 → i32 → f32 → i32 → u32.
//
// Input x [R, N] (u32 words or f32), output [N]: the sum over the rows of
// each row after K rounds (u32 sums wrap; f32 sums run in row order).
//
// Design: one thread per element, its R rows in registers; the R rows of
// a round are independent (R-way ILP), so the rate read is the issue rate
// of the op, not its latency. R is a template argument (1, 2, 4, 8, 16) so
// the rows stay in registers; K is a runtime argument, so the compiler
// cannot fold the rounds.
//
// What bounds it on the card: operations (R·K rounds an element against
// 4·(R + 1) bytes), by design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { kU32Add, kU32Mul, kU16Mul, kShiftAnd, kF32Mul, kF32Fma, kCvt, kNumOps };

template <int kOp>
struct Elem {
  using T = uint32_t;
};
template <>
struct Elem<kF32Mul> {
  using T = float;
};
template <>
struct Elem<kF32Fma> {
  using T = float;
};

template <int kOp, typename T>
__device__ __forceinline__ T round_op(T v) {
  if constexpr (kOp == kU32Add) return v + (v | 1u);
  if constexpr (kOp == kU32Mul) return v * (v | 1u);
  if constexpr (kOp == kU16Mul) return (v & 0xFFFFu) * 3u;
  if constexpr (kOp == kShiftAnd) return (v >> 3) & 0xFFFFu;
  if constexpr (kOp == kF32Mul) return v * v;
  if constexpr (kOp == kF32Fma) return fmaf(v, v, v);
  if constexpr (kOp == kCvt)
    return static_cast<uint32_t>(__float2int_rz(__int2float_rn(static_cast<int32_t>(v))));
}

template <int kOp, int kR>
__global__ void __launch_bounds__(256) op_rate_kernel(const typename Elem<kOp>::T* __restrict__ x,
                                                      typename Elem<kOp>::T* __restrict__ out,
                                                      int64_t n, int rounds) {
  using T = typename Elem<kOp>::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T v[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) v[r] = x[r * n + i];
#pragma unroll 4
  for (int k = 0; k < rounds; ++k) {
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = round_op<kOp>(v[r]);
  }
  T acc = v[0];
#pragma unroll
  for (int r = 1; r < kR; ++r) acc = acc + v[r];
  out[i] = acc;
}

template <int kOp, int kR>
int launch(const void* x, void* out, int64_t n, int rounds, cudaStream_t s) {
  using T = typename Elem<kOp>::T;
  const int64_t blocks = (n + 255) / 256;
  op_rate_kernel<kOp, kR><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, rounds);
  return static_cast<int>(cudaGetLastError());
}

template <int kOp>
int launch_rows(const void* x, void* out, int rows, int64_t n, int rounds, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<kOp, 1>(x, out, n, rounds, s);
    case 2: return launch<kOp, 2>(x, out, n, rounds, s);
    case 4: return launch<kOp, 4>(x, out, n, rounds, s);
    case 8: return launch<kOp, 8>(x, out, n, rounds, s);
    case 16: return launch<kOp, 16>(x, out, n, rounds, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// op: the class's index in bellpepper_tpu_torch.backend.op_rate.OPS.
extern "C" int bp_op_rate(const void* x, void* out, int rows, int64_t n, int op, int rounds,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kU32Add: return launch_rows<kU32Add>(x, out, rows, n, rounds, s);
    case kU32Mul: return launch_rows<kU32Mul>(x, out, rows, n, rounds, s);
    case kU16Mul: return launch_rows<kU16Mul>(x, out, rows, n, rounds, s);
    case kShiftAnd: return launch_rows<kShiftAnd>(x, out, rows, n, rounds, s);
    case kF32Mul: return launch_rows<kF32Mul>(x, out, rows, n, rounds, s);
    case kF32Fma: return launch_rows<kF32Fma>(x, out, rows, n, rounds, s);
    case kCvt: return launch_rows<kCvt>(x, out, rows, n, rounds, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
