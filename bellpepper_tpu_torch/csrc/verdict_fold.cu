// The packed check's verdict fold: the count of violations and the least
// instance-major index of one, over the bad words or bytes of a set of
// template rows, added into a running verdict on the device.
//
// Replaces no Pallas kernel. The reference writes the fold in jnp
// (bellpepper_tpu/backend/matvec.py verdict_packed, :3002-3060), where
// XLA fuses each fold into one reduction; run eagerly, the same fold is
// some fifty int64 ops over every bad word (a SWAR popcount and ctz, an
// index tensor and its minimum). This kernel restores the fusion.
//
// Inputs, two forms:
//   words (kShift = 0): u32 rows [n, ld] of packed bad words, bit j of
//     word w set where instance 32·w + j violates; only the low
//     clamp(n_inst − 32·w, 0, 32) bits of word w count (the others are
//     padding instances), and only the first ceil(n_inst / 32) words of a
//     row are read;
//   bytes (kShift = 3): u8 rows [n, ld] of a bool mask, byte b nonzero
//     where instance b violates; the first n_inst bytes of a row are read.
// rows i64[n]: the template row of each input row; R: the template's row
// count. acc u64[2] = (n_bad, first) on the device: the launch adds its
// count to acc[0] and lowers acc[1] to its least b·R + rows[r], so the
// folds of one verdict chain with no host sync (the caller starts acc at
// (0, int64 max)).
//
// What bounds it on the card: the bytes of the bad words, read once
// (5.1 GB for the sha256 check's 19,529 word rows at 2^21 instances, 1.5
// ms at 3.35 TB/s). The work a word is a popcount and an add; a nonzero
// word, rare in an honest batch, adds an ffs, a row read and a 64-bit
// multiply-add and minimum.
//
// Design. A grid-stride loop over the n rows × units a row, a unit 16
// bytes (one vector load) where the base, the row stride and the row width
// are 16-byte multiples, one element otherwise; each thread walks its
// units with the row and column carried by adds (no division in the
// loop), keeps kUnroll loads in flight before it folds them, and holds
// its count and minimum in registers. A block reduces them with warp
// shuffles and shared memory, then makes one atomicAdd and one atomicMin
// (each only when it found something), so the result is exact and the
// same in any order. The grid is the blocks that fit on the card at once,
// fewer for a small input; indices are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned long long kNone = 0x7FFFFFFFFFFFFFFFull;

struct Fold {
  uint32_t count = 0;  // at most 32 a word, far below 2^32 for any input a card holds
  unsigned long long best = kNone;
};

// One nonzero-tested 32-bit word: `x` its live bits, `inst0` the instance
// of its bit 0 (or byte 0), kShift the log2 of the bits an instance takes.
template <int kShift>
__device__ __forceinline__ void fold_word(Fold& f, uint32_t x, long long inst0, const long long* rows,
                                          long long r, long long R) {
  if (!x) return;
  f.count += __popc(x);
  const unsigned long long inst = inst0 + ((__ffs(x) - 1) >> kShift);
  const unsigned long long cand = inst * R + __ldg(rows + r);
  f.best = cand < f.best ? cand : f.best;
}

// The live bits of word column w: the low clamp(n_inst − 32·w, 0, 32).
__device__ __forceinline__ uint32_t live_bits(long long w, long long n_inst) {
  const long long rem = n_inst - 32 * w;
  return rem >= 32 ? 0xFFFFFFFFu : (rem <= 0 ? 0u : (1u << rem) - 1u);
}

template <int kShift, bool kVec>
__global__ void __launch_bounds__(kThreads)
verdict_fold_kernel(const void* __restrict__ bad, long long ld, long long n, long long units,
                    long long n_inst, const long long* __restrict__ rows, long long R,
                    unsigned long long* __restrict__ acc) {
  using Unit = typename std::conditional<kVec, uint4, typename std::conditional<kShift == 0, uint32_t,
                                                                                 uint8_t>::type>::type;
  // elements (words or bytes) a unit and a row stride in units
  constexpr int kElems = kVec ? 16 >> (kShift == 0 ? 2 : 0) : 1;
  const Unit* base = static_cast<const Unit*>(bad);
  const long long ld_units = ld / kElems;

  const long long start = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long r = start / units, c = start % units;
  const long long dr = stride / units, dc = stride % units;
  Fold f;
  while (r < n) {
    Unit v[kUnroll];
    long long rr[kUnroll], cc[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      rr[k] = r;
      cc[k] = c;
      if (r < n) v[k] = __ldg(base + r * ld_units + c);
      c += dc;
      r += dr;
      if (c >= units) {
        c -= units;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (rr[k] >= n) break;
      if constexpr (kVec) {
        // most units of an honest batch are zero: one test skips them
        if (!(v[k].x | v[k].y | v[k].z | v[k].w)) continue;
        const uint32_t x[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (kShift == 0) {
            const long long w = 4 * cc[k] + q;
            fold_word<0>(f, x[q] & live_bits(w, n_inst), 32 * w, rows, rr[k], R);
          } else {
            fold_word<3>(f, x[q], 16 * cc[k] + 4 * q, rows, rr[k], R);
          }
        }
      } else if constexpr (kShift == 0) {
        fold_word<0>(f, v[k] & live_bits(cc[k], n_inst), 32 * cc[k], rows, rr[k], R);
      } else {
        fold_word<0>(f, v[k] != 0, cc[k], rows, rr[k], R);
      }
    }
  }

  // block reduction: warp shuffles, then the warps' partials in shared memory
  unsigned long long count = f.count;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xFFFFFFFFu, count, off);
    const unsigned long long b = __shfl_down_sync(0xFFFFFFFFu, f.best, off);
    f.best = b < f.best ? b : f.best;
  }
  __shared__ unsigned long long s_count[kThreads / 32], s_best[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_count[warp] = count;
    s_best[warp] = f.best;
  }
  __syncthreads();
  if (warp == 0) {
    count = lane < kThreads / 32 ? s_count[lane] : 0;
    f.best = lane < kThreads / 32 ? s_best[lane] : kNone;
#pragma unroll
    for (int off = kThreads / 64; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xFFFFFFFFu, count, off);
      const unsigned long long b = __shfl_down_sync(0xFFFFFFFFu, f.best, off);
      f.best = b < f.best ? b : f.best;
    }
    if (lane == 0) {
      if (count) atomicAdd(acc, count);
      if (f.best != kNone) atomicMin(acc + 1, f.best);
    }
  }
}

template <int kShift, bool kVec>
cudaError_t launch(const void* bad, long long ld, long long n, long long width, long long n_inst,
                   const long long* rows, long long R, unsigned long long* acc, cudaStream_t stream) {
  constexpr int kElems = kVec ? 16 >> (kShift == 0 ? 2 : 0) : 1;
  const long long units = width / kElems;
  static int per_sm = 0;  // resident blocks an SM, the same on every card of one build
  if (!per_sm) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, verdict_fold_kernel<kShift, kVec>, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = (n * units + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(need < full ? need : full);
  verdict_fold_kernel<kShift, kVec><<<blocks, kThreads, 0, stream>>>(bad, ld, n, units, n_inst, rows, R, acc);
  return cudaGetLastError();
}

}  // namespace

// bad: the rows' base pointer; ld: the row stride in elements (words or
// bytes); width: the elements a row to read; mask: 1 for bytes, 0 for
// words; vec: 1 where base, ld and width allow 16-byte loads.
extern "C" int bp_verdict_fold(const void* bad, int64_t ld, int64_t n, int64_t width, int mask, int64_t n_inst,
                               const int64_t* rows, int64_t R, unsigned long long* acc, int vec, void* stream) {
  if (n <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* rw = reinterpret_cast<const long long*>(rows);
  cudaError_t err;
  if (mask)
    err = vec ? launch<3, true>(bad, ld, n, width, n_inst, rw, R, acc, s)
              : launch<3, false>(bad, ld, n, width, n_inst, rw, R, acc, s);
  else
    err = vec ? launch<0, true>(bad, ld, n, width, n_inst, rw, R, acc, s)
              : launch<0, false>(bad, ld, n, width, n_inst, rw, R, acc, s);
  return static_cast<int>(err);
}
