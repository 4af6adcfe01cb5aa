// The packed witness evaluator's addmany stage: W sums of n words each,
// 32 instances a uint32 word (bit j of a word is instance j), every sum
// mod 2^n_out, its n_out bit planes written straight into the value
// buffer.
//
// Replaces no Pallas kernel. The reference evaluates the stage in jnp
// (bellpepper_tpu/compile/witness_program.py _build_packed_impl,
// :1245-1286): CSA 3:2 layers over whole [W, n_out] plane stacks, then a
// Kogge-Stone prefix add, which XLA fuses. Run eagerly, the same adder is
// about ninety torch ops a stage over [W, n_out, Bw] temporaries, each
// made by a zero fill and a cat. This kernel walks the bit positions in
// series instead, the per-position adder that the reference avoided only
// because it compiles slowly on XLA.
//
// Inputs (n_out ≥ 32: every addend is a 32-bit word):
//   vals u32 [S, Bw]: the value buffer, slot-major, read and written in
//     place (the stage's outputs are slots that no addend of the stage
//     reads);
//   desc i32 [W, n, 32]: one descriptor a plane, addend i of sum w at bit
//     k: (slot << 1) | neg for a variable view (the slot's words, all bits
//     flipped when neg), −1 − value for a constant view (all zeros or all
//     ones);
//   outs i32 [W, n_out]: the slot that takes sum w's bit plane k.
//
// What bounds it on the card: the bytes, each addend plane read once and
// each sum plane written once, (32·n + n_out) planes of 4·Bw bytes a sum
// (blake2s's 80 stages at Bw 65,536: 10.9 GB a call, 3.3 ms at 3.35
// TB/s). The work, a few bitwise ops a plane and word, is far below the
// card's integer rate.
//
// Design. A thread owns kV adjacent words (kV·32 instances) of one sum and
// walks k = 0 … n_out − 1. It keeps the column's running carry as a
// bit-sliced binary counter of kM words (instance j's count in bit j of
// each word). At bit k it loads the n addend planes (none above bit 31),
// adds them into the counter two at a time (a full adder at the counter's
// bit 0, then the carry rippled up only as far as the count can reach),
// writes the counter's bit 0 as sum plane k, and shifts the counter down
// one bit: the carry into k + 1. With n addends the count at a position
// is at most 2n − 1, so kM = bit_length(2n − 1) words suffice. The n loads
// of position k + 1 are issued before position k's adds and store, so two
// positions' loads are in flight a thread. Every load and store is
// coalesced along Bw: kV·4 bytes a thread, 16 where Bw and the buffer
// allow. n up to 8 has its own instantiation, everything unrolled; larger
// n takes the addends in chunks of 8 with a 16-word counter (n < 2^15).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 2;  // positions whose planes are loaded at once a thread (the one added and those ahead)
constexpr int kChunk = 8;  // the addends loaded at once where n is not a template argument

__host__ __device__ constexpr int bit_length(int x) { return x ? 1 + bit_length(x >> 1) : 0; }

template <int kV>
__device__ __forceinline__ void load_words(uint32_t (&x)[kV], const uint32_t* p) {
  if constexpr (kV == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (kV == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int kV>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&x)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// One addend plane: the words of the view that descriptor d names.
template <int kV>
__device__ __forceinline__ void load_plane(uint32_t (&x)[kV], const uint32_t* vals, long long Bw, long long col,
                                           int d) {
  if (d >= 0) {
    load_words<kV>(x, vals + static_cast<long long>(d >> 1) * Bw + col);
    const uint32_t m = 0u - static_cast<uint32_t>(d & 1);
#pragma unroll
    for (int q = 0; q < kV; ++q) x[q] ^= m;
  } else {
    const uint32_t c = d == -2 ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int q = 0; q < kV; ++q) x[q] = c;
  }
}

// The counter bits that a count of at most `reach` occupies, at most kM.
__host__ __device__ constexpr int reach_bits(int reach, int kM) {
  return bit_length(reach) < kM ? bit_length(reach) : kM;
}

// counter c += the kC planes p; before the add the counter holds at most
// kBefore (n − 1 where n is a template argument; 2^kM − 1 − kC where it is
// not, which leaves every bit in play), so adding planes i and i + 1
// reaches at most kBefore + i + 2, and the carry ripples only through the
// bits that this count can occupy (a carry out of them is zero).
template <int kC, int kM, int kV, int kBefore>
__device__ __forceinline__ void add_planes(uint32_t (&c)[kM][kV], const uint32_t (&p)[kC][kV]) {
#pragma unroll
  for (int i = 0; i < kC; i += 2) {
    const int bits = reach_bits(kBefore + (i + 2 < kC ? i + 2 : kC), kM);
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      uint32_t cy;
      if (i + 1 < kC) {
        const uint32_t a = p[i][q], b = p[i + 1][q], s = c[0][q];
        cy = (a & b) | (s & (a ^ b));
        c[0][q] = a ^ b ^ s;
      } else {
        cy = c[0][q] & p[i][q];
        c[0][q] ^= p[i][q];
      }
#pragma unroll
      for (int j = 1; j < kM; ++j) {
        if (j < bits) {
          const uint32_t t = c[j][q] & cy;
          c[j][q] ^= cy;
          cy = t;
        }
      }
    }
  }
}

// write counter bit 0 as sum plane k, then carry: counter >>= 1
template <int kM, int kV>
__device__ __forceinline__ void emit(uint32_t (&c)[kM][kV], uint32_t* vals, long long Bw, long long col,
                                     const int* ow, int k) {
  store_words<kV>(vals + static_cast<long long>(__ldg(ow + k)) * Bw + col, c[0]);
#pragma unroll
  for (int j = 0; j + 1 < kM; ++j)
#pragma unroll
    for (int q = 0; q < kV; ++q) c[j][q] = c[j + 1][q];
#pragma unroll
  for (int q = 0; q < kV; ++q) c[kM - 1][q] = 0;
}

// kN addends (fixed), kM = bit_length(2·kN − 1) counter words; the
// positions' planes go through a ring of kDepth buffers, position k + kDepth
// − 1 loaded before position k is added and stored
template <int kN, int kV>
__global__ void __launch_bounds__(kThreads)
addmany_fixed_kernel(uint32_t* vals, long long Bw, const int* __restrict__ desc, const int* __restrict__ outs,
                     long long W, int n_out, long long units) {
  constexpr int kM = bit_length(2 * kN - 1);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= W * units) return;
  const long long w = t / units;
  const long long col = (t - w * units) * kV;
  const int* dw = desc + w * kN * 32;
  const int* ow = outs + w * n_out;

  uint32_t c[kM][kV] = {};
  uint32_t p[kDepth][kN][kV];
#pragma unroll
  for (int k = 0; k + 1 < kDepth; ++k)
#pragma unroll
    for (int i = 0; i < kN; ++i) load_plane<kV>(p[k][i], vals, Bw, col, __ldg(dw + i * 32 + k));
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k + kDepth - 1 < 32) {
#pragma unroll
      for (int i = 0; i < kN; ++i)
        load_plane<kV>(p[(k + kDepth - 1) % kDepth][i], vals, Bw, col, __ldg(dw + i * 32 + k + kDepth - 1));
    }
    add_planes<kN, kM, kV, kN - 1>(c, p[k % kDepth]);
    emit<kM, kV>(c, vals, Bw, col, ow, k);
  }
  for (int k = 32; k < n_out; ++k) emit<kM, kV>(c, vals, Bw, col, ow, k);
}

// any n below 2^15: chunks of kChunk addends into a 16-word counter
template <int kV>
__global__ void __launch_bounds__(kThreads)
addmany_chunked_kernel(uint32_t* vals, long long Bw, const int* __restrict__ desc, const int* __restrict__ outs,
                       long long W, int n, int n_out, long long units) {
  constexpr int kM = 16;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= W * units) return;
  const long long w = t / units;
  const long long col = (t - w * units) * kV;
  const int* dw = desc + w * n * 32;
  const int* ow = outs + w * n_out;

  uint32_t c[kM][kV] = {};
  for (int k = 0; k < 32; ++k) {
    for (int i0 = 0; i0 < n; i0 += kChunk) {
      uint32_t p[kChunk][kV];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i0 + i < n) {
          load_plane<kV>(p[i], vals, Bw, col, __ldg(dw + (i0 + i) * 32 + k));
        } else {
#pragma unroll
          for (int q = 0; q < kV; ++q) p[i][q] = 0;
        }
      }
      add_planes<kChunk, kM, kV, (1 << kM) - 1 - kChunk>(c, p);
    }
    emit<kM, kV>(c, vals, Bw, col, ow, k);
  }
  for (int k = 32; k < n_out; ++k) emit<kM, kV>(c, vals, Bw, col, ow, k);
}

template <int kV>
cudaError_t launch(uint32_t* vals, long long Bw, const int* desc, const int* outs, long long W, int n, int n_out,
                   cudaStream_t stream) {
  const long long units = Bw / kV;
  const long long blocks = (W * units + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (n) {
#define BP_FIXED(N) \
  case N:           \
    addmany_fixed_kernel<N, kV><<<grid, kThreads, 0, stream>>>(vals, Bw, desc, outs, W, n_out, units); break;
    BP_FIXED(1) BP_FIXED(2) BP_FIXED(3) BP_FIXED(4) BP_FIXED(5) BP_FIXED(6) BP_FIXED(7) BP_FIXED(8)
#undef BP_FIXED
    default:
      addmany_chunked_kernel<kV><<<grid, kThreads, 0, stream>>>(vals, Bw, desc, outs, W, n, n_out, units);
  }
  return cudaGetLastError();
}

}  // namespace

// vals: the value buffer [S, Bw]; desc [W, n, 32], outs [W, n_out] as
// above; vec: the words a thread, 1, 2 or 4 (the caller checks that Bw and
// the buffer's base allow 4·vec-byte accesses).
extern "C" int bp_addmany_packed(void* vals, int64_t Bw, const int* desc, const int* outs, int64_t W, int n,
                                 int n_out, int vec, void* stream) {
  if (Bw <= 0 || W <= 0 || n <= 0 || n >= (1 << 15) || n_out < 32 || Bw % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* v = static_cast<uint32_t*>(vals);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vec) {
    case 4: err = launch<4>(v, Bw, desc, outs, W, n, n_out, s); break;
    case 2: err = launch<2>(v, Bw, desc, outs, W, n, n_out, s); break;
    case 1: err = launch<1>(v, Bw, desc, outs, W, n, n_out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
