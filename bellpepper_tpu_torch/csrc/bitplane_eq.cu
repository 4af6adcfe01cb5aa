// Bit-sliced integer equality over exponent planes: the MultiEq
// power-of-two row check of the packed sha256 path.
//
// Replaces: bellpepper_tpu/backend/field_pallas.py make_bitplane_eq_kernel
// (the Pallas TPU kernel reached through
// bellpepper_tpu/backend/matvec.py _pow2_eq_bad_words_pallas), together
// with the plane gather in front of it.
//
// Inputs: the packed slot-major witness vals_p u32[S, Bw] and the plane
// table planes i32[(m_a + m_c)·P·n]: entry ((k·P + e)·n + i) is the slot
// whose words are addend k's plane for exponent e of pow2 row i (addends
// k < m_a on the A side, the others on the C side), or −1 for an empty
// plane. Each word carries 32 independent instances, one per bit. Output
// bad u32[n, Bw]: bit j of word (i, w) is set iff Σ 2^e·A-bits ≢ Σ 2^e·
// C-bits (mod 2^P) for that instance of row i, which is what the TPU
// kernel's carry-save + local-carry-rule form decides (the classifier's
// headroom makes mod 2^P equal to integer equality).
//
// Design. One thread per column word; a block is one warp over 32 words
// of one row, so the 25 × 1,024 column words of the sha256 chunk make 800
// blocks. The thread walks the positions upward and adds every plane of
// the position into a bit-sliced vertical counter held in registers (A
// planes, the one's complement of the C planes, and the +m_c of two's
// complement at m_c's set bits); the counter's low plane is the
// difference's bit at that position, and shifting the counter down
// carries into the next position. The difference is zero mod 2^P iff no
// low plane ever has a bit set. The block first copies its row's plane
// slots into shared memory (and a mask of each position's live planes),
// then stages the planes of 4 positions at a
// time (each plane 128 contiguous bytes of vals_p) with cp.async, three
// stages in a ring, so the next positions' loads are in flight while the
// counter walks the current ones. An empty plane is never loaded: it adds nothing on the A side and
// all ones (the complement of zero) on the C side. (m_a, m_c) is a
// template argument for the sha256 shape (7, 1), with a generic
// instantiation for the others.
//
// What bounds it on the card: bytes. The launch reads each live plane's
// words once (4 KB a plane at Bw = 1,024) and writes one word a column;
// the counter work is about a dozen integer ops per plane word.
#include "field.cuh"

namespace {

constexpr int kCols = 32;    // column words a block (one warp)
constexpr int kPos = 4;      // positions a stage
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kMaxAddends = 30;  // m_a + m_c + 1 <= 31

// Counter planes for A = m_a + m_c + 1 addends a position (the planes and
// the constant's bit): the count after a position's adds is at most A plus
// half the count before, so at most 2A − 1 — 5 planes for (7, 1), 6 for
// any A <= 31.
__host__ __device__ constexpr int counter_planes(int addends) { return 2 * addends - 1 < 32 ? 5 : 6; }

template <int kPlanes>
__device__ __forceinline__ void add_plane(uint32_t (&cnt)[kPlanes], uint32_t b) {
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) {
    const uint32_t t = cnt[j] & b;
    cnt[j] ^= b;
    b = t;
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kMA = 0: m_a and m_c from the arguments. vec: 16-byte copies are
// aligned (vals_p 16-byte aligned, Bw % 4 == 0).
template <int kMA, int kMC>
__global__ void __launch_bounds__(kCols)
bitplane_eq_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ planes,
                   uint32_t* __restrict__ bad, int n, int64_t Bw, int P, int m_a_arg,
                   int m_c_arg, int vec) {
  const int m_a = kMA ? kMA : m_a_arg, m_c = kMA ? kMC : m_c_arg, M = m_a + m_c;
  constexpr int kPlanes = counter_planes(kMA ? kMA + kMC + 1 : kMaxAddends + 1);
  // dynamic shared memory: the row's plane slots [M][P], each position's
  // live-plane mask [P], then the ring [kStages][kPos·M][kCols]
  extern __shared__ __align__(16) uint32_t smem[];
  int* tab = reinterpret_cast<int*>(smem);
  uint32_t* live = smem + M * P;
  uint32_t* ring = smem + ((M * P + P + 3) & ~3);
  const int tid = threadIdx.x;
  const int64_t n_tiles = (Bw + kCols - 1) / kCols;
  const int i = static_cast<int>(blockIdx.x / n_tiles);
  const int64_t w0 = (blockIdx.x % n_tiles) * kCols;
  const int n_st = P / kPos;

  // the row's plane table first, all its loads in flight together, so the
  // copies below wait on no global load
#pragma unroll 8
  for (int q = tid; q < M * P; q += kCols)
    tab[q] = __ldg(planes + static_cast<int64_t>(q) * n + i);  // q = k·P + e
  __syncthreads();
  for (int e = tid; e < P; e += kCols) {
    uint32_t m = 0;
    for (int k = 0; k < M; ++k) m |= static_cast<uint32_t>(tab[k * P + e] >= 0) << k;
    live[e] = m;
  }
  __syncthreads();

  auto load_stage = [&](int st) {
    uint32_t* buf = ring + (st % kStages) * kPos * M * kCols;
    for (int q = tid; q < kPos * M * (kCols / 4); q += kCols) {
      const int row = q / (kCols / 4), j = (q % (kCols / 4)) * 4;
      const int e = st * kPos + row / M, k = row % M;
      const int s = tab[k * P + e];
      if (s < 0) continue;  // an empty plane is never read
      uint32_t* dst = buf + row * kCols + j;
      const int64_t wc = w0 + j;
      const uint32_t* src = vals + static_cast<int64_t>(s) * Bw + wc;
      if (vec) {
        cp16(dst, wc < Bw ? src : vals, wc < Bw);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) cp4(dst + u, wc + u < Bw ? src + u : vals, wc + u < Bw);
      }
    }
  };

  uint32_t cnt[kPlanes];
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) cnt[j] = 0;
  uint32_t diff = 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) load_stage(st);
    cp_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < n_st) load_stage(st + kStages - 1);
    cp_commit();
    const uint32_t* buf = ring + (st % kStages) * kPos * M * kCols;
#pragma unroll
    for (int ee = 0; ee < kPos; ++ee) {
      const int e = st * kPos + ee;
      const uint32_t* row = buf + ee * M * kCols + tid;
      const uint32_t lm = live[e];
#pragma unroll
      for (int k = 0; k < (kMA ? kMA : kMaxAddends); ++k) {
        if (!kMA && k >= m_a) break;
        if ((lm >> k) & 1) add_plane(cnt, row[k * kCols]);
      }
#pragma unroll
      for (int k = 0; k < (kMA ? kMC : kMaxAddends); ++k) {
        if (!kMA && k >= m_c) break;
        add_plane(cnt, (lm >> (m_a + k)) & 1 ? ~row[(m_a + k) * kCols] : 0xFFFFFFFFu);
      }
      if (e < 31 && ((m_c >> e) & 1)) add_plane(cnt, 0xFFFFFFFFu);
      diff |= cnt[0];
#pragma unroll
      for (int j = 0; j + 1 < kPlanes; ++j) cnt[j] = cnt[j + 1];
      cnt[kPlanes - 1] = 0;
    }
  }
  cp_wait<0>();
  if (w0 + tid < Bw) bad[static_cast<int64_t>(i) * Bw + w0 + tid] = diff;
}

template <int kMA, int kMC>
int launch(const uint32_t* vals, const int32_t* planes, uint32_t* bad, int n, int64_t Bw, int P,
           int m_a, int m_c, int vec, cudaStream_t s) {
  const int M = m_a + m_c;
  const int smem = (((M * P + P + 3) & ~3) + kStages * kPos * M * kCols) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(bitplane_eq_kernel<kMA, kMC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = static_cast<int64_t>(n) * ((Bw + kCols - 1) / kCols);
  bitplane_eq_kernel<kMA, kMC><<<static_cast<unsigned>(blocks), kCols, smem, s>>>(
      vals, planes, bad, n, Bw, P, m_a, m_c, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bp_bitplane_eq(const uint32_t* vals, const int32_t* planes, uint32_t* bad, int n,
                              int64_t Bw, int P, int m_a, int m_c, int vec, void* stream) {
  if (m_a + m_c + 1 > 31 || P < kPos || P % kPos)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_a == 7 && m_c == 1) return launch<7, 1>(vals, planes, bad, n, Bw, P, m_a, m_c, vec, s);
  return launch<0, 0>(vals, planes, bad, n, Bw, P, m_a, m_c, vec, s);
}
