// Flash attention, forward: softmax(q k^T / sqrt(Dh) + mask) v for one
// (BH, Sq, Dh) query tensor against (BH, Sk, Dh) keys and values, bf16 or
// f32, with the causal mask kpos <= qpos counted from position 0 for both.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_kernel :33, _flash_fwd_impl :88, pallas_call :106).  The TPU walked the
// kv blocks as a sequential grid axis and carried the running max, sum and
// accumulator in VMEM scratch from one grid step to the next.  Hopper blocks
// run in parallel and in no order, so here each thread block owns one
// (bh, query tile) and loops over the kv tiles itself, keeping those
// statistics on chip for the whole loop:
//
//   - bf16 (the LM trainer's path): 4 warps, 16 query rows each (a 64-row
//     tile), kv tiles of 64 keys (32 at Dh > 128).  Q k^T and P v run on
//     the tensor cores as mma.sync m16n8k16 bf16 products with f32
//     accumulation; the scores, the running max and sum and the output
//     accumulator stay in registers, and P goes from the score fragment to
//     the PV operand without touching shared memory.  Dh is padded with
//     zeros to 16, 32, 64, 128 or 256 inside shared memory only.
//   - f32: plain FMA in f32 (no TF32) over 32x32 tiles in shared memory,
//     for checks of the algorithm at full precision.
//
// Both stop at the diagonal under the causal mask (a masked tile adds
// exactly 0, so skipping it changes no result), mask the ragged edge of Sq
// and Sk themselves, and take any Dh that is a multiple of 8 up to 256.  A
// masked score is -inf and a row whose maximum is still -inf takes 0 as its
// shift, so no tile can leave m = -1e30 with l = 0; the last division is by
// max(l, 1e-30), as in the reference.  Scores, statistics and the
// accumulator are f32; the output is written once in q's dtype.
//
// What bounds it on an H100 SXM at the trainer's shape (BH = 64 = batch 4 x
// 16 heads, S = 2,048, Dh = 128, bf16): the causal half of Q k^T and P v is
// about 6.9e10 flops, 0.07 ms at the dense bf16 peak of 989 TFLOP/s, while
// Q + K + V + O is 134 MB, 0.04 ms at 3.35 TB/s.  So operations bind, and
// only the tensor cores can approach the bound.  This first kernel uses
// mma.sync with synchronous tile loads; wgmma, TMA and a producer warp are
// the next step.  Two calls on one input are bitwise equal: every sum runs
// in a fixed order, with no atomics.

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

}  // extern "C"
