// Flash attention, forward: softmax(q k^T / sqrt(Dh) + mask) v for one
// (BH, Sq, Dh) query tensor against (BH, Sk, Dh) keys and values, bf16 or
// f32, with the causal mask kpos <= qpos counted from position 0 for both.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_kernel :33, _flash_fwd_impl :88, pallas_call :106).  The TPU walked the
// kv blocks as a sequential grid axis and carried the running max, sum and
// accumulator in VMEM scratch from one grid step to the next.  Hopper blocks
// run in parallel and in no order, so here each thread block owns a
// (bh, query tile) and loops over the kv tiles itself, keeping those
// statistics on chip for the whole loop.  Two routes, chosen on the host
// (flash_attention.py: route) from dtype and Dh alone:
//
//   - "wgmma", bf16 at Dh 64, 128 and 256 (the LM trainer's path): the
//     Hopper kernel at the end of this file (TMA, mbarriers, wgmma, warp
//     specialisation, a persistent grid);
//   - "mma", every other input: for bf16, 4 warps, 16 query rows each (a
//     64-row tile), kv tiles of 64 keys (32 at Dh > 128).  Q k^T and P v
//     run on the tensor cores as mma.sync m16n8k16 bf16 products with f32
//     accumulation; the scores, the running max and sum and the output
//     accumulator stay in registers, and P goes from the score fragment to
//     the PV operand without touching shared memory.  Dh is padded with
//     zeros to 16, 32, 64, 128 or 256 inside shared memory only.  For f32,
//     plain FMA in f32 (no TF32) over 32x32 tiles in shared memory, for
//     checks of the algorithm at full precision.
//
// All stop at the diagonal under the causal mask (a masked tile adds
// exactly 0, so skipping it changes no result), mask the ragged edge of Sq
// and Sk themselves, and together take any Dh that is a multiple of 8 up to
// 256.  A masked score is -inf and a row whose maximum is still -inf takes 0
// as its shift, so no tile can leave m = -1e30 with l = 0; the last division
// is by max(l, 1e-30), as in the reference.  Scores, statistics and the
// accumulator are f32; the output is written once in q's dtype.
//
// What bounds them on an H100 SXM at the trainer's shape (BH = 64 = batch 4
// x 16 heads, S = 2,048, Dh = 128, bf16): the causal half of Q k^T and P v
// is about 6.9e10 flops, 0.07 ms at the dense bf16 peak of 989 TFLOP/s,
// while Q + K + V + O is 134 MB, 0.04 ms at 3.35 TB/s.  So operations bind,
// and only wgmma reaches the tensor cores' full rate; mma.sync with
// synchronous tile loads stays near 0.13 of the bound.  Two calls on one
// input are bitwise equal: every sum runs in a fixed order, with no atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;       // bf16 path: query rows per block
constexpr int kT32 = 32;               // f32 path: query rows and keys per tile

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats as one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + rows) of a (S, dh) bf16 matrix into shared memory with
// row stride SD, zero beyond S and beyond dh (up to D)
template <int D, int SD>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int row0, int rows, int s, int dh) {
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    int r = i / kChunks, d0 = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < s && d0 < dh)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * dh + d0);
    *reinterpret_cast<uint4*>(dst + r * SD + d0) = val;
  }
}

template <int D>
struct Bf16Tiles {
  static constexpr int kBk = D <= 128 ? 64 : 32;   // keys per kv tile
  static constexpr int kSD = D + 8;                // smem row stride (elements)
  static constexpr int kSmem = (kBq + 2 * kBk) * kSD * 2;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                  int sq, int sk, int dh, int causal, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int kBk = T::kBk, kSD = T::kSD;
  constexpr int kN = kBk / 8;          // score fragments (8 keys) per tile
  constexpr int kNd = D / 8;           // output fragments (8 dims) per row
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* ks = qs + kBq * kSD;
  uint16_t* vs = ks + kBk * kSD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;   // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * sq * dh, koff = (size_t)bh * sk * dh;

  load_tile<D, kSD>(qs, q + qoff, q0, kBq, sq, dh);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;   // this thread's rows
  const int warp_last = q0 + warp * 16 + 15;
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, min(q0 + kBq, sq) - 1);
  const int n_tiles = last_key / kBk + 1;

  float o_acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint16_t* qw = qs + (warp * 16 + g) * kSD + 2 * t;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBk;
    __syncthreads();                   // the previous tile is consumed
    load_tile<D, kSD>(ks, k + koff, k0, kBk, sk, dh);
    load_tile<D, kSD>(vs, v + koff, k0, kBk, sk, dh);
    __syncthreads();
    if (causal && k0 > warp_last) continue;   // every row of this warp masked

    float s[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4] = {ld32(qw + 16 * kk), ld32(qw + 8 * kSD + 16 * kk),
                       ld32(qw + 16 * kk + 8), ld32(qw + 8 * kSD + 16 * kk + 8)};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const uint16_t* kp = ks + (8 * j + g) * kSD + 16 * kk + 2 * t;
        uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(s[j], a, b);
      }
    }

    // mask, scale and the tile's row maxima (rows g and g + 8 of the warp)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const bool ok0 = key < sk && (!causal || key <= row0);
        const bool ok1 = key < sk && (!causal || key <= row1);
        s[j][e] = ok0 ? s[j][e] * scale : -INFINITY;
        s[j][2 + e] = ok1 ? s[j][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
    const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
    const float c0 = expf(m0 - sh0), c1 = expf(m1 - sh1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;        // this thread's share of the row sums
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      s[j][0] = expf(s[j][0] - sh0);
      s[j][1] = expf(s[j][1] - sh0);
      s[j][2] = expf(s[j][2] - sh1);
      s[j][3] = expf(s[j][3] - sh1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      o_acc[n][0] *= c0;
      o_acc[n][1] *= c0;
      o_acc[n][2] *= c1;
      o_acc[n][3] *= c1;
    }

    // o += P v: two score fragments (16 keys) make one A operand
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vp = vs + (16 * kk + 2 * t) * kSD + g;
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
        const uint16_t* vn = vp + 8 * n;
        uint32_t b[2] = {(uint32_t)vn[0] | ((uint32_t)vn[kSD] << 16),
                         (uint32_t)vn[8 * kSD] | ((uint32_t)vn[9 * kSD] << 16)};
        mma_bf16(o_acc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  uint16_t* out = o + qoff;
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= dh) break;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)row0 * dh + d) =
          pack_bf16(o_acc[n][0] / den0, o_acc[n][1] / den0);
    if (row1 < sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)row1 * dh + d) =
          pack_bf16(o_acc[n][2] / den1, o_acc[n][3] / den1);
  }
}

size_t f32_smem(int dh) {
  const int sd = dh + 1;
  return (size_t)(4 * kT32 * sd + kT32 * (kT32 + 1) + 2 * kT32) * 4;
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int sq, int sk, int dh, int causal, float scale) {
  extern __shared__ float fsm[];
  const int sd = dh + 1;               // odd stride: a column read is conflict free
  float* qs = fsm;
  float* ks = qs + kT32 * sd;
  float* vs = ks + kT32 * sd;
  float* os = vs + kT32 * sd;
  float* ps = os + kT32 * sd;          // (32, 33) scores, then weights
  float* corr = ps + kT32 * (kT32 + 1);
  float* lsum = corr + kT32;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT32;
  const int tid = threadIdx.x;
  const size_t qoff = (size_t)bh * sq * dh, koff = (size_t)bh * sk * dh;

  for (int i = tid; i < kT32 * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    qs[r * sd + d] = q0 + r < sq ? q[qoff + (size_t)(q0 + r) * dh + d] : 0.f;
    os[r * sd + d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;        // row tid's statistics (tid < 32)
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, min(q0 + kT32, sq) - 1);
  const int n_tiles = last_key / kT32 + 1;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kT32;
    __syncthreads();
    for (int i = tid; i < kT32 * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const bool in = k0 + r < sk;
      ks[r * sd + d] = in ? k[koff + (size_t)(k0 + r) * dh + d] : 0.f;
      vs[r * sd + d] = in ? v[koff + (size_t)(k0 + r) * dh + d] : 0.f;
    }
    __syncthreads();
    const int j = tid % kT32;
    for (int i = tid / kT32; i < kT32; i += kThreads / kT32) {
      const int key = k0 + j, row = q0 + i;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc += qs[i * sd + d] * ks[j * sd + d];
      const bool ok = key < sk && (!causal || key <= row);
      ps[i * (kT32 + 1) + j] = ok ? acc * scale : -INFINITY;
    }
    __syncthreads();
    if (tid < kT32) {
      float* pr = ps + tid * (kT32 + 1);
      float mx = -INFINITY;
      for (int jj = 0; jj < kT32; ++jj) mx = fmaxf(mx, pr[jj]);
      const float mn = fmaxf(m, mx);
      const float sh = mn == -INFINITY ? 0.f : mn;
      const float c = expf(m - sh);
      float sum = 0.f;
      for (int jj = 0; jj < kT32; ++jj) {
        pr[jj] = expf(pr[jj] - sh);
        sum += pr[jj];
      }
      m = mn;
      l = l * c + sum;
      corr[tid] = c;
    }
    __syncthreads();
    for (int i = tid; i < kT32 * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const float* pr = ps + r * (kT32 + 1);
      float acc = os[r * sd + d] * corr[r];
      for (int jj = 0; jj < kT32; ++jj) acc += pr[jj] * vs[jj * sd + d];
      os[r * sd + d] = acc;
    }
  }
  if (tid < kT32) lsum[tid] = fmaxf(l, 1e-30f);
  __syncthreads();
  for (int i = tid; i < kT32 * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    if (q0 + r < sq) o[qoff + (size_t)(q0 + r) * dh + d] = os[r * sd + d] / lsum[r];
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int bh, int sq, int sk, int dh, int causal, float scale,
                        cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  // above 48 KB of dynamic shared memory a launch is refused without this
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kBq - 1) / kBq);
  flash_bf16_kernel<D><<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), sq, sk, dh,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace flash


// ---------------------------------------------------------------------------
// bf16 at Dh = 64, 128 and 256 on Hopper: TMA, mbarriers, wgmma, warp
// specialisation (the "wgmma" route; the kernel above is the "mma" route)
// ---------------------------------------------------------------------------
//
// One block of 384 threads per SM (persistent: the shared memory allows no
// more) walks work items, each one (bh, 128-row query tile); block b takes
// items b, b + gridDim.x, ..., ordered longest first under the causal mask,
// so the blocks' loads even out:
//   - warpgroup 0, the producer, gives up registers (setmaxnreg 24) and one
//     of its threads issues every TMA load: each item's Q tile, then its K
//     and V tiles (kBk keys each) into a ring of 2 stages, with an
//     arrival and a release barrier for each K and each V buffer and
//     for Q; the ring's slots and phases run on across items, so the next
//     item's loads overlap this item's last products and its epilogue;
//   - warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 query rows
//     each.  Per kv tile: S = Q K^T as Dh / 16 wgmma m64n(kBk)k16 with both
//     operands in 128-byte-swizzled shared memory and f32 accumulators in
//     registers; the online softmax on those registers (exp2 with the scale
//     folded in); P rounded to bf16 stays in registers as the A operand of
//     O += P V, kBk / 16 wgmma m64nDk16 (two m64n128k16 at Dh 256) whose B
//     operand is V in its natural (keys, Dh) layout read through the
//     transpose bit.  P never touches shared memory.  A consumer issues S
//     of tile t and P V of tile t - 1 together and waits for S alone, so
//     its softmax of tile t runs while the tensor cores do its P V (and
//     the other consumer's products); it releases each K buffer after its
//     S, each V buffer after its P V, and Q after the item's last S.
// The accumulator layout of wgmma is the layout of its register A operand
// for 16-bit types, so P needs no shuffle.  TMA fills rows past Sq or Sk
// with zeros; the causal mask stops the kv loop after the last tile that
// holds a key <= the item's last query, and only the tiles that the
// diagonal crosses (any key past the consumer's first row) and a ragged
// last tile are masked (-inf), as above.  Every sum runs in a fixed order
// with no atomics, so two launches are bitwise equal.
//
// Dh 256 (gemma3's global layers) runs the same design with kv tiles of 80
// keys (Tiles): Q (64 KiB) and a 2-stage ring of 80-key K and V tiles (40
// KiB each) make 230,480 bytes with the barriers and the alignment, just
// under the 232,448 a block may have, where 128-key tiles would need 321
// KiB (64-key tiles, 197,712 bytes, measured 1-4% slower).  Each tile row
// is 4 swizzled boxes of 64 columns, and S is Dh / 16 = 16 wgmma
// m64n80k16 a tile.  With kBk < kBq the diagonal crosses up to three kv
// tiles of an item; a tile all masked for consumer 0 adds exactly 0.  A
// consumer holds O (128 f32), one S tile (40), P (20) and its row
// statistics, inside setmaxnreg 240 (no spills).  Its blocks take their
// items in snake order (item() in the kernel): the grid's balance, not the
// tile, was the larger gain (0.1735 -> 0.1274 ms at (8, 4096, 256) with
// 64-key tiles).
//
// At the trainer's shape it reaches about 0.42 of the bound, some 10%
// behind SDPA (PERF.md); ping-pong turns between the two consumers and a
// third ring stage measured no gain there, so neither is here.

namespace flash_hopper {

constexpr int kBq = 128;               // query rows per block, 64 per consumer
constexpr int kStages = 2;             // K and V buffers in the ring
constexpr int kThreads = 384;          // 3 warpgroups
constexpr int kCols = 64;              // bf16 columns in one 128-byte swizzled box

template <int D>
struct Tiles {
  // keys per kv tile: 128 at Dh 64 and 128; 80 at Dh 256, where Q and a
  // ring of 128-key tiles would need 321 KiB
  static constexpr int kBk = D <= 128 ? 128 : 80;
  // at Dh 256 the rounds of items alternate in direction (see item())
  static constexpr bool kSnake = D > 128;
};

template <int D>
struct Smem {
  static constexpr int kBk = Tiles<D>::kBk;
  static constexpr int kQ = kBq * D * 2;           // bytes of the Q tile
  static constexpr int kKV = kBk * D * 2;          // bytes of one K or V tile
  static constexpr int kBars = 2 + 4 * kStages;    // mbarriers
  // tiles 1024-byte aligned (the 128-byte swizzle), then the barriers
  static constexpr int kAlloc = 1024 + kQ + 2 * kStages * kKV + 8 * kBars;
  static_assert(kAlloc <= 232448, "tiles exceed a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one box of a 3-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (m64 x n128, f32) (+)= A (m64 x k16, shared) * B (k16 x n128, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (m64 x n80, f32) (+)= A (m64 x k16, shared) * B (k16 x n80, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (m64 x n128, f32) += A (m64 x k16, bf16 registers) * B (k16 x n128, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n64, f32) += A (m64 x k16, bf16 registers) * B (k16 x n64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S (m64 x nN) (+)= Q K^T over one k-step: N keys of the kv tile
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128(s, da, db, accumulate);
  else wgmma_ss_n80(s, da, db, accumulate);
}

// O += P V over one k-step of 16 keys; v_row addresses the k-step's rows
// of V's first 64-column box, and the boxes lie lbo = BK * 128 bytes
// apart.  At Dh 256, two n128 products: columns 0-127 (boxes 0 and 1) and
// 128-255 (boxes 2 and 3), whose registers in that order are an n256
// product's accumulator (one m64n256k16 measured no faster).
template <int D, int BK>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint32_t v_row, uint32_t lbo) {
  if constexpr (D == 256) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a,
                  gmma_desc(v_row, lbo, 1024));
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                  gmma_desc(v_row + 2 * BK * 128, lbo, 1024));
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, gmma_desc(v_row, lbo, 1024));
  } else {
    wgmma_rs_n64(o, a, gmma_desc(v_row, lbo, 1024));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, uint16_t* __restrict__ o,
                   int bh_count, int sq, int sk, int causal, float scale_log2) {
  using S = Smem<D>;
  constexpr int kBk = Tiles<D>::kBk;
  constexpr int kCB = D / kCols;       // 128-byte column blocks of a tile row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + S::kQ;            // [stage][column block][key][128 B]
  uint8_t* vs = ks + kStages * S::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * S::kKV);
  uint64_t* q_free = q_full + 1;       // both consumers are done with the Q tile
  uint64_t* k_full = q_free + 1;       // a K tile has landed
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_free = v_full + kStages; // both consumers are done with a K tile
  uint64_t* v_free = k_free + kStages;

  // work item w: query tile n_qt - 1 - w / bh_count (the longest first) of
  // head w % bh_count; block b takes items b, b + gridDim.x, ..., one a
  // round of gridDim.x items.  At Dh 256 the rounds alternate in
  // direction, counted back from the last (maybe partial) round, which
  // runs forwards: block b takes a backward round's item gridDim.x - 1 -
  // b, so that the block with one round's longest item gets the next
  // round's shortest.  The busiest block's kv tiles fall from 1.5 to 1.0
  // times the mean at (8, 4096, 256) (256 items on 132 blocks), from 1.22
  // to 1.03 at (32, 2048, 256).
  const int n_qt = (sq + kBq - 1) / kBq;
  const int n_work = n_qt * bh_count;
  auto item = [&](int w, int& bh, int& q0) {
    if constexpr (Tiles<D>::kSnake) {
      const int g = gridDim.x, r = w / g;
      if (((n_work - 1) / g - r) & 1) w = r * g + g - 1 - w % g;
    }
    bh = w % bh_count;
    q0 = (n_qt - 1 - w / bh_count) * kBq;
    int last_key = sk - 1;
    if (causal) last_key = min(last_key, min(q0 + kBq, sq) - 1);
    return last_key / kBk + 1;         // kv tiles
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_free, 2);              // one arrival per consumer warpgroup
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_free[i], 2);
      mbar_init(&v_free[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, item after item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                      // kv tiles loaded so far
      int wi = 0;                      // items begun so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++wi) {
        int bh, q0;
        const int n_tiles = item(w, bh, q0);
        mbar_wait(q_free, (wi & 1) ^ 1);
        mbar_expect_tx(q_full, S::kQ);
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(qs + cb * kBq * 128, &tq, q_full, cb * kCols, q0, bh);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int st = it % kStages, ph = (it / kStages) & 1;
          mbar_wait(&k_free[st], ph ^ 1);
          mbar_expect_tx(&k_full[st], S::kKV);
          for (int cb = 0; cb < kCB; ++cb)
            tma_load(ks + st * S::kKV + cb * kBk * 128, &tk, &k_full[st], cb * kCols,
                     t * kBk, bh);
          mbar_wait(&v_free[st], ph ^ 1);
          mbar_expect_tx(&v_full[st], S::kKV);
          for (int cb = 0; cb < kCB; ++cb)
            tma_load(vs + st * S::kKV + cb * kBk * 128, &tv, &v_full[st], cb * kCols,
                     t * kBk, bh);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows q0 + 64c .. q0 + 64c + 63 of each
    // item.  Its softmax of tile t overlaps its own P V of tile t - 1 on the
    // tensor cores (and the other warpgroup's products).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, quad = lane % 4;
    const int row_in_tile = 64 * c + 16 * (tid / 32) + lane / 4;
    const uint32_t q_addr = smem_u32(qs) + 64 * c * 128;

    float o_acc[D / 2];
    float s[kBk / 2];
    uint32_t p[kBk / 16][4];           // P of the previous tile, the A operand of P V
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) s[i] = 0.f;
    int it = 0, wi = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++wi) {
      int bh, q0;
      const int n_tiles = item(w, bh, q0);
      const int row0 = q0 + row_in_tile, row1 = row0 + 8;
      const int wg_first = q0 + 64 * c;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 0.f, c1 = 0.f;

      // S = Q K^T for kv tile t (ring slot i): k-steps of 16 columns (32
      // bytes) inside each column block
      auto qk = [&](int i) {
        const uint32_t k_addr = smem_u32(ks + (i % kStages) * S::kKV);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_qk<kBk>(s, gmma_desc(q_addr + (kk / 4) * kBq * 128 + off, 16, 1024),
                        gmma_desc(k_addr + (kk / 4) * kBk * 128 + off, 16, 1024), kk > 0);
        }
      };
      // O += P V (ring slot i): k-steps of 16 keys (2 KB of the V tile), V
      // read MN-major
      auto pv = [&](int i) {
        const uint32_t v_addr = smem_u32(vs + (i % kStages) * S::kKV);
#pragma unroll
        for (int kk = 0; kk < kBk / 16; ++kk)
          wgmma_pv<D, kBk>(o_acc, p[kk], v_addr + kk * 16 * 128, kBk * 128);
      };
      // the online softmax of tile t on S, in place: exp2 with the scale
      // folded in, the shift in log2 units; c0, c1 rescale the rows' O
      auto softmax = [&](int t) {
        const int k0 = t * kBk;
        if (k0 + kBk > sk || (causal && k0 + kBk - 1 > wg_first)) {
#pragma unroll
          for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + 2 * quad + e;
              if (!(key < sk && (!causal || key <= row0))) s[4 * j + e] = -INFINITY;
              if (!(key < sk && (!causal || key <= row1))) s[4 * j + 2 + e] = -INFINITY;
            }
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float sh0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
        const float sh1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
        c0 = ex2(m0 * scale_log2 - sh0);
        c1 = ex2(m1 * scale_log2 - sh1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j) {
          s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -sh0));
          s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -sh0));
          s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -sh1));
          s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -sh1));
          ps0 += s[4 * j] + s[4 * j + 1];
          ps1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * c0 + ps0;
        l1 = l1 * c1 + ps1;
      };
      // P to bf16: n8 blocks 2kk and 2kk + 1 of S make the A fragment of
      // k-step kk
      auto pack = [&]() {
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j) {
          p[j / 2][(j % 2) * 2] = flash::pack_bf16(s[4 * j], s[4 * j + 1]);
          p[j / 2][(j % 2) * 2 + 1] = flash::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        }
      };

      mbar_wait(q_full, wi & 1);
      mbar_wait(&k_full[it % kStages], (it / kStages) & 1);
      fence_regs(s);
      wg_fence();
      qk(it);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      if (tid == 0) {
        mbar_arrive(&k_free[it % kStages]);
        if (n_tiles == 1) mbar_arrive(q_free);
      }
      softmax(0);
      pack();

      for (int t = 1; t < n_tiles; ++t) {
        const int i = it + t;
        mbar_wait(&k_full[i % kStages], (i / kStages) & 1);
        mbar_wait(&v_full[(i - 1) % kStages], ((i - 1) / kStages) & 1);
        fence_regs(s);
        fence_regs(o_acc);
        fence_regs(p);
          wg_fence();
        qk(i);
        wg_commit();
        pv(i - 1);
        wg_commit();
          wg_wait<1>();                  // S of tile t is in; P V of t - 1 runs on
        fence_regs(s);
        if (tid == 0) {
          mbar_arrive(&k_free[i % kStages]);
          if (t == n_tiles - 1) mbar_arrive(q_free);   // the item's last Q K^T
        }
        softmax(t);
        wg_wait<0>();
        fence_regs(o_acc);
        fence_regs(p);
        if (tid == 0) mbar_arrive(&v_free[(i - 1) % kStages]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o_acc[4 * j] *= c0;
          o_acc[4 * j + 1] *= c0;
          o_acc[4 * j + 2] *= c1;
          o_acc[4 * j + 3] *= c1;
        }
        pack();
      }
      const int last = it + n_tiles - 1;
      mbar_wait(&v_full[last % kStages], (last / kStages) & 1);
      fence_regs(o_acc);
      fence_regs(p);
      wg_fence();
      pv(last);
      wg_commit();
      wg_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      if (tid == 0) mbar_arrive(&v_free[last % kStages]);
      it += n_tiles;

#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
        l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
      }
      const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
      uint16_t* out = o + (size_t)bh * sq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = 8 * j + 2 * quad;
        if (row0 < sq)
          *reinterpret_cast<uint32_t*>(out + (size_t)row0 * D + d) =
              flash::pack_bf16(o_acc[4 * j] / den0, o_acc[4 * j + 1] / den0);
        if (row1 < sq)
          *reinterpret_cast<uint32_t*>(out + (size_t)row1 * D + d) =
              flash::pack_bf16(o_acc[4 * j + 2] / den1, o_acc[4 * j + 3] / den1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no -lcuda on the nvcc line)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (bh, s, dh) bf16 tensor as boxes of (rows, 64 columns), 128-byte
// swizzled; rows past s read as zeros
static bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int dh, int rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)s, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)s * dh * 2};
  cuuint32_t box[3] = {(cuuint32_t)kCols, (cuuint32_t)rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                   int sk, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  constexpr int kBk = Tiles<D>::kBk;
  if (!make_map(&tq, q, bh, sq, D, kBq) || !make_map(&tk, k, bh, sk, D, kBk) ||
      !make_map(&tv, v, bh, sk, D, kBk))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  // persistent: one block per SM (the shared memory allows no more)
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long work = (long long)bh * ((sq + kBq - 1) / kBq);
  const int grid = (int)(work < sms ? work : sms > 0 ? sms : 1);
  flash_wgmma_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), bh, sq, sk, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace flash_hopper

using namespace flash;

extern "C" {

// dtype: 0 = f32, 1 = bf16.  q (bh, sq, dh), k and v (bh, sk, dh), o like q,
// all contiguous on the device.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bh, int sq, int sk, int dh, int causal, int dtype,
                        void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || dh < 8 || dh > 256 || dh % 8 != 0 ||
      (sq + kT32 - 1) / kT32 > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = f32_smem(dh);
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(bh, (sq + kT32 - 1) / kT32);
    flash_f32_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, dh,
        causal, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (dh <= 16) return (int)launch_bf16<16>(q, k, v, o, bh, sq, sk, dh, causal, scale, st);
  if (dh <= 32) return (int)launch_bf16<32>(q, k, v, o, bh, sq, sk, dh, causal, scale, st);
  if (dh <= 64) return (int)launch_bf16<64>(q, k, v, o, bh, sq, sk, dh, causal, scale, st);
  if (dh <= 128) return (int)launch_bf16<128>(q, k, v, o, bh, sq, sk, dh, causal, scale, st);
  return (int)launch_bf16<256>(q, k, v, o, bh, sq, sk, dh, causal, scale, st);
}

// The wgmma route: bf16 q (bh, sq, dh), k and v (bh, sk, dh), o like q,
// contiguous on the device, 16-byte aligned, dh 64, 128 or 256.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel does not take, or when no tensor-map encoder is found).
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                              int bh, int sq, int sk, int dh, int causal, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (sq + flash_hopper::kBq - 1) / flash_hopper::kBq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return (int)flash_hopper::launch<64>(q, k, v, o, bh, sq, sk, causal, st);
  if (dh == 128) return (int)flash_hopper::launch<128>(q, k, v, o, bh, sq, sk, causal, st);
  if (dh == 256) return (int)flash_hopper::launch<256>(q, k, v, o, bh, sq, sk, causal, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the wgmma route's kernel at dh (0: not taken).
int flash_attention_wgmma_smem(int dh) {
  if (dh == 64) return flash_hopper::Smem<64>::kAlloc;
  if (dh == 128) return flash_hopper::Smem<128>::kAlloc;
  if (dh == 256) return flash_hopper::Smem<256>::kAlloc;
  return 0;
}

}  // extern "C"
