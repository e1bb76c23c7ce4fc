// Fused token-plate substep for Hopper: gather -> softmax -> sufficient stats.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_zstats.py:zstats
// (_zstats_call, _kernel, _block_step) in both its resident and its streamed
// layout: a Hopper block gathers straight from device memory at any table
// size, so one kernel covers both.  Per token i of a flat latent:
//
//   logits_i = Elog_prior[prior_rows[i]] + sum_c mask_c[i] * message_c(i)
//   r_i      = softmax(logits_i) * zmask[i]
//   lse_sum += logsumexp(logits_i) * zmask[i]
//   prior_stats[prior_rows[i]] += r_i
//   child_stats_c[row_c(i, k), values_c[i]] += mask_c[i] * r_ik
//
// where a specialized child's row is k and a strided child's row is
// base_c[i] + stride_c * k.  The (N, K) logits and responsibilities never
// reach device memory.
//
// Owner passes, no float atomics.  Every output element has one owner warp
// that sums its tokens in a fixed order, so two runs give bitwise-equal
// results.  The host groups the tokens by key once per program (numpy
// stable argsort of the static index streams) and cuts each key's run into
// pieces of at most a few hundred tokens, so one hot key does not serialise
// the pass:
//   - zstats_pieces: one warp per piece recomputes each token's logits and
//     r in registers (lane l holds topics l, l+32, ...) and writes the
//     piece's K-vector sum (and, for the prior pass, its lse sum).  The
//     piece's key fixes one operand row (the prior row in the prior pass,
//     the word's row in a child's pass), loaded once; the other rows are
//     gathered per token;
//   - zstats_finish: one warp per key adds its pieces in order and writes
//     the key's row (prior stats) or column (specialized child stats);
//   - zstats_strided: one warp per value column of a strided child walks
//     that column's tokens in order and adds r into rows base + stride*k
//     (slow for a hot value; strided children are off the main path);
//   - zstats_sum: one block adds the per-piece lse sums in a fixed order.
//
// Bound on the H100: operations.  The call moves its token streams, tables
// and stats once each (188 MB at the 10M-token main path, 0.06 ms at
// 3.35 TB/s) but does about 8 f32 operations per token and topic (0.12 ms
// at 67 TFLOP/s).  In practice a warp walks its tokens one at a time, so
// the passes are bound by the issue of each token's two warp reductions and
// the latency of its gathered rows.  The design keeps the gathered tables
// f32 and small enough for the 50 MB L2, loads the owner key's row once per
// piece rather than once per token, and spends one division per token.
//
// Segment latents.  The same passes also replace the Pallas TPU kernel
// repro/kernels/fused_zmap.py:zstats_zmap (_phase_logits/_logits_kernel,
// _phase_stats/_stats_kernel, and the extra=/emit_r= use of
// fused_zstats._zstats_call).  A latent whose child carries a zmap (token t
// -> latent instance zmap[t]: an SLDA sentence, a naive Bayes document)
// needs a cross-token sum before its softmax, so it runs in three phases:
//   1. zmap_logits: the host groups each zmap child's tokens by instance;
//      a warp per piece sums mask * message in f64, and zstats_finish64
//      writes (or, for a later zmap child, adds) each instance's row of the
//      (n_latent, K) f32 logits, rounded once, children in order;
//   2a. the prior pass above over the latent instances, with those logits
//      as `extra` after the prior row, writes each instance's r row once
//      (`r_out`) besides the prior stats, the lse and the stats of any
//      child without a zmap;
//   2b. zmap_stats: the host groups each zmap child's tokens by value; a
//      warp per piece sums mask * r[zmap] and zstats_finish writes the
//      value's column of the stats (zmap_strided walks a strided child's
//      value column in token order).
// Bound on the H100 at the SLDA main path (10M tokens, 1.44M sentences,
// K = 100): operations, about 0.08 ms, just above the 0.06 ms that its
// inputs and outputs take at 3.35 TB/s.  The (n_latent, K) logits and r
// are intermediates of 0.58 GB each and the logits' f64 per-piece partials
// 1.15 GB, written and read once more (about 1.4 ms of traffic that a fused
// kernel would not move); the design accepts that for owner passes without
// atomics, and phase 1 and 2b gather only one K-row per token (the message,
// or r).
//
// Tables arrive as f32 Elog values (the wrapper's Triton pre-pass computes
// them from f32 or bf16 concentrations); accumulation is f32.  K may be
// anything from 1 to 1024 (KPL = K per lane, a template parameter).
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define MAX_CHILDREN 8
#define WARPS_PER_BLOCK 8
#define SUM_THREADS 1024

struct ZChildArgs {
  const float* table;   // specialized: (Kf, K) Elog, transposed; else (Gf, Kf)
  const int* values;    // (N,) observed value per token
  const int* base;      // (N,) row base, or null for all-zero
  const float* mask;    // (N,) token validity, or null
  const int* zmap;      // (N,) token -> latent instance (segment latents), or null
  int stride;
  int kf;               // value-axis length of the parent table
  int specialized;
};

struct ZArgs {
  const float* prior;       // (G, K) Elog
  const int* prior_rows;    // (N,)
  const float* zmask;       // (N,) or null
  const float* extra;       // (N, K) logits added after the prior row, or null
  float* r_out;             // (N, K) responsibilities written by the prior pass, or null
  int k;
  int n_children;
  ZChildArgs c[MAX_CHILDREN];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Child ch's message for token i (lane's share, 0 past K), before its mask,
// for the segment-latent passes: a specialized child's row v_i of its
// (Kf, K) table, a strided child's column v_i at rows base_i + stride * k.
// token_logits keeps its own copy of these gathers: calling this helper
// there made LDA's flat owner passes 13% slower on the H100 (PERF.md).
template <int KPL>
__device__ __forceinline__ void child_message(const ZChildArgs& ch, int i, int lane, int k,
                                              float (&e)[KPL]) {
  const int v = ch.values[i];
  if (ch.specialized) {
    const float* row = ch.table + (size_t)v * k;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      e[j] = kk < k ? row[kk] : 0.0f;
    }
  } else {
    const int b = ch.base ? ch.base[i] : 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      e[j] = kk < k ? ch.table[(size_t)(b + ch.stride * kk) * ch.kf + v] : 0.0f;
    }
  }
}

// Token i's logits (lane's share; lanes past K hold -inf): the prior row,
// then (EXTRA, a segment latent's prior pass) the instance's row of the
// extra logits, then each child's masked message.  The operand row of
// `fixed` (-1: the prior, c >= 0: specialized child c) is `frow`, the row
// the piece's owner key selects, loaded once per piece; every other row is
// gathered.  fixed = -2 gathers every row.  The branches on `fixed` stay
// outside the lane loops, so no row is fetched that is not used.  EXTRA is
// a template parameter so that the flat latents' passes compile without it.
template <int KPL, bool EXTRA>
__device__ __forceinline__ void token_logits(const ZArgs& a, int i, int lane, int fixed,
                                             const float (&frow)[KPL], float (&x)[KPL]) {
  const int k = a.k;
  if (fixed == -1) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) x[j] = lane + 32 * j < k ? frow[j] : -INFINITY;
  } else {
    const float* prow = a.prior + (size_t)a.prior_rows[i] * k;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      x[j] = kk < k ? prow[kk] : -INFINITY;
    }
  }
  if constexpr (EXTRA) {
    const float* erow = a.extra + (size_t)i * k;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      if (kk < k) x[j] += erow[kk];
    }
  }
  for (int c = 0; c < a.n_children; ++c) {
    const ZChildArgs& ch = a.c[c];
    const int v = ch.values[i];
    const float mk = ch.mask ? ch.mask[i] : 1.0f;
    if (c == fixed) {
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        if (lane + 32 * j < k) x[j] += frow[j] * mk;
    } else if (ch.specialized) {
      const float* row = ch.table + (size_t)v * k;
      float e[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kk = lane + 32 * j;
        e[j] = kk < k ? row[kk] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        if (lane + 32 * j < k) x[j] += e[j] * mk;
    } else {
      const int b = ch.base ? ch.base[i] : 0;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kk = lane + 32 * j;
        if (kk < k) x[j] += ch.table[(size_t)(b + ch.stride * kk) * ch.kf + v] * mk;
      }
    }
  }
}

// Logits -> responsibilities in place (times zm); returns the masked lse.
// One division per token: the lanes multiply by zm / sum.
template <int KPL>
__device__ __forceinline__ float softmax_r(float (&x)[KPL], int lane, int k, float zm) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < KPL; ++j) m = fmaxf(m, x[j]);
  m = warp_max(m);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int kk = lane + 32 * j;
    x[j] = kk < k ? expf(x[j] - m) : 0.0f;
    s += x[j];
  }
  s = warp_sum(s);
  const float scale = zm / s;
#pragma unroll
  for (int j = 0; j < KPL; ++j) x[j] *= scale;
  return (m + logf(s)) * zm;
}

// One warp per piece: the piece's sum of r (target < 0: the prior pass, which
// also sums lse and, for a segment latent (EXTRA), writes each instance's r
// row to r_out: every instance lies in exactly one piece of that pass) or of
// mask_target * r (target >= 0: a specialized child).  All tokens of a piece
// share the owner key, so its table row is loaded once.
template <int KPL, bool EXTRA>
__global__ void pieces_kernel(ZArgs a, int target, const int* __restrict__ perm,
                              const int* __restrict__ piece_start, int n_pieces,
                              float* __restrict__ partial, float* __restrict__ lse_part) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_pieces) return;
  const int k = a.k;
  const int t0 = piece_start[warp], t1 = piece_start[warp + 1];
  const int i0 = perm[t0];
  const float* fsrc = target < 0 ? a.prior + (size_t)a.prior_rows[i0] * k
                                 : a.c[target].table + (size_t)a.c[target].values[i0] * k;
  float frow[KPL], acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int kk = lane + 32 * j;
    frow[j] = kk < k ? fsrc[kk] : 0.0f;
    acc[j] = 0.0f;
  }
  const float* wmask = target >= 0 ? a.c[target].mask : nullptr;
  float lse_acc = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const int i = perm[t];
    float x[KPL];
    token_logits<KPL, EXTRA>(a, i, lane, target < 0 ? -1 : target, frow, x);
    lse_acc += softmax_r<KPL>(x, lane, k, a.zmask ? a.zmask[i] : 1.0f);
    if (EXTRA && target < 0) {
      float* rrow = a.r_out + (size_t)i * k;
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        if (lane + 32 * j < k) rrow[lane + 32 * j] = x[j];
    }
    const float w = wmask ? wmask[i] : 1.0f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc[j] += x[j] * w;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int kk = lane + 32 * j;
    if (kk < k) partial[(size_t)warp * k + kk] = acc[j];
  }
  if (target < 0 && lane == 0) lse_part[warp] = lse_acc;
}

// One warp per key: add the key's pieces in order, in T; write out[key, kk]
// at key * stride_key + kk * stride_k, rounded once to f32 (add != 0: add
// to it).  Keys without tokens write zeros (add nothing).
template <typename T>
__global__ void finish_kernel(const T* __restrict__ partial,
                              const int* __restrict__ key_pieces, int n_keys, int k,
                              float* __restrict__ out, long long stride_key,
                              long long stride_k, int add) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_keys) return;
  const int p0 = key_pieces[warp], p1 = key_pieces[warp + 1];
  for (int kk = lane; kk < k; kk += 32) {
    T acc = 0;
    for (int p = p0; p < p1; ++p) acc += partial[(size_t)p * k + kk];
    float* o = out + warp * stride_key + kk * stride_k;
    *o = add ? (float)(*o + acc) : (float)acc;
  }
}

// One warp per value column of a strided child: walk the column's tokens in
// order and add mask * r into rows base + stride * k of out (zeroed).
template <int KPL, bool EXTRA>
__global__ void strided_kernel(ZArgs a, int target, const int* __restrict__ perm,
                               const int* __restrict__ key_start, int n_keys,
                               float* __restrict__ out) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_keys) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const int t1 = key_start[warp + 1];
  for (int t = key_start[warp]; t < t1; ++t) {
    const int i = perm[t];
    float r[KPL];
    token_logits<KPL, EXTRA>(a, i, lane, -2, r, r);   // no fixed row: the first r is unread
    softmax_r<KPL>(r, lane, k, a.zmask ? a.zmask[i] : 1.0f);
    const float w = ch.mask ? ch.mask[i] : 1.0f;
    const int b = ch.base ? ch.base[i] : 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      if (kk < k) out[(size_t)(b + ch.stride * kk) * ch.kf + warp] += r[j] * w;
    }
    __syncwarp();   // rows may repeat across tokens and lanes: keep token order
  }
}

// --- segment latents (a child with a zmap: SLDA sentences, naive Bayes
// documents).  The ZArgs of these passes hold the zmap children only.

// Phase 1, one warp per piece of child `target`'s tokens grouped by latent
// instance: the piece's sum of mask * message, the instance's logits share.
// The sum is f64, and so are the partials that zstats_finish64 adds: a naive
// Bayes document's logits reach thousands of nats, where f32 sums of its
// few hundred messages lose the hundredths of a nat that decide r for a
// document near a tie between two classes.
template <int KPL>
__global__ void zmap_logits_kernel(ZArgs a, int target, const int* __restrict__ perm,
                                   const int* __restrict__ piece_start, int n_pieces,
                                   double* __restrict__ partial) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_pieces) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  double acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) acc[j] = 0.0;
  const int t1 = piece_start[warp + 1];
  for (int t = piece_start[warp]; t < t1; ++t) {
    const int i = perm[t];
    const float mk = ch.mask ? ch.mask[i] : 1.0f;
    float e[KPL];
    child_message<KPL>(ch, i, lane, k, e);
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc[j] += (double)e[j] * mk;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int kk = lane + 32 * j;
    if (kk < k) partial[(size_t)warp * k + kk] = acc[j];
  }
}

// Phase 2b, one warp per piece of a specialized child's tokens grouped by
// value: the piece's sum of mask * r[zmap], the value column's share.
template <int KPL>
__global__ void zmap_stats_kernel(ZArgs a, int target, const float* __restrict__ r,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ piece_start, int n_pieces,
                                  float* __restrict__ partial) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_pieces) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  float acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) acc[j] = 0.0f;
  const int t1 = piece_start[warp + 1];
  for (int t = piece_start[warp]; t < t1; ++t) {
    const int i = perm[t];
    const float w = ch.mask ? ch.mask[i] : 1.0f;
    const float* rrow = r + (size_t)ch.zmap[i] * k;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      if (kk < k) acc[j] += rrow[kk] * w;
    }
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int kk = lane + 32 * j;
    if (kk < k) partial[(size_t)warp * k + kk] = acc[j];
  }
}

// Phase 2b of a strided child: one warp per value column walks the column's
// tokens in order and adds mask * r[zmap] into rows base + stride * k of out
// (zeroed).
template <int KPL>
__global__ void zmap_strided_kernel(ZArgs a, int target, const float* __restrict__ r,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ key_start, int n_keys,
                                    float* __restrict__ out) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_keys) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const int t1 = key_start[warp + 1];
  for (int t = key_start[warp]; t < t1; ++t) {
    const int i = perm[t];
    const float w = ch.mask ? ch.mask[i] : 1.0f;
    const int b = ch.base ? ch.base[i] : 0;
    const float* rrow = r + (size_t)ch.zmap[i] * k;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      if (kk < k) out[(size_t)(b + ch.stride * kk) * ch.kf + warp] += rrow[kk] * w;
    }
    __syncwarp();   // rows may repeat across tokens and lanes: keep token order
  }
}

// One block: out[0] = sum of x in a fixed order (strided per thread, then a
// fixed tree).
__global__ void sum_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  __shared__ float buf[SUM_THREADS];
  float acc = 0.0f;
  for (int t = threadIdx.x; t < n; t += SUM_THREADS) acc += x[t];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

static int kpl_of(int k) {
  if (k <= 32) return 1;
  if (k <= 64) return 2;
  if (k <= 128) return 4;
  if (k <= 256) return 8;
  if (k <= 512) return 16;
  if (k <= 1024) return 32;
  return 0;
}

static inline unsigned blocks_for(int warps) {
  return (unsigned)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

// Call launch(std::integral_constant<int, KPL>()) with K's topics per lane;
// returns the launch's error.
template <typename F>
static int dispatch_kpl(int k, F launch) {
  switch (kpl_of(k)) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 8: launch(std::integral_constant<int, 8>()); break;
    case 16: launch(std::integral_constant<int, 16>()); break;
    case 32: launch(std::integral_constant<int, 32>()); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#define THREADS (32 * WARPS_PER_BLOCK)

extern "C" {

int zstats_max_k(void) { return 1024; }

int zstats_max_children(void) { return MAX_CHILDREN; }

int zstats_args_size(void) { return (int)sizeof(ZArgs); }

int zstats_pieces(const void* args, int target, const void* perm, const void* piece_start,
                  int n_pieces, void* partial, void* lse_part, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_pieces <= 0) return 0;
  const unsigned grid = blocks_for(n_pieces);
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_kpl(a.k, [&](auto kpl) {
    constexpr int KPL = decltype(kpl)::value;
    if (a.extra)
      pieces_kernel<KPL, true><<<grid, THREADS, 0, s>>>(
          a, target, (const int*)perm, (const int*)piece_start, n_pieces, (float*)partial,
          (float*)lse_part);
    else
      pieces_kernel<KPL, false><<<grid, THREADS, 0, s>>>(
          a, target, (const int*)perm, (const int*)piece_start, n_pieces, (float*)partial,
          (float*)lse_part);
  });
}

int zstats_finish(const void* partial, const void* key_pieces, int n_keys, int k, void* out,
                  long long stride_key, long long stride_k, int add, void* stream) {
  if (n_keys <= 0) return 0;
  finish_kernel<float><<<blocks_for(n_keys), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (const int*)key_pieces, n_keys, k, (float*)out, stride_key,
      stride_k, add);
  return (int)cudaGetLastError();
}

// zstats_finish over f64 partials (phase 1 of a segment latent).
int zstats_finish64(const void* partial, const void* key_pieces, int n_keys, int k,
                    void* out, long long stride_key, long long stride_k, int add,
                    void* stream) {
  if (n_keys <= 0) return 0;
  finish_kernel<double><<<blocks_for(n_keys), THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)partial, (const int*)key_pieces, n_keys, k, (float*)out, stride_key,
      stride_k, add);
  return (int)cudaGetLastError();
}

int zstats_strided(const void* args, int target, const void* perm, const void* key_start,
                   int n_keys, void* out, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_keys <= 0) return 0;
  const unsigned grid = blocks_for(n_keys);
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_kpl(a.k, [&](auto kpl) {
    constexpr int KPL = decltype(kpl)::value;
    if (a.extra)
      strided_kernel<KPL, true><<<grid, THREADS, 0, s>>>(
          a, target, (const int*)perm, (const int*)key_start, n_keys, (float*)out);
    else
      strided_kernel<KPL, false><<<grid, THREADS, 0, s>>>(
          a, target, (const int*)perm, (const int*)key_start, n_keys, (float*)out);
  });
}

int zmap_logits(const void* args, int target, const void* perm, const void* piece_start,
                int n_pieces, void* partial, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_pieces <= 0) return 0;
  return dispatch_kpl(a.k, [&](auto kpl) {
    zmap_logits_kernel<decltype(kpl)::value>
        <<<blocks_for(n_pieces), THREADS, 0, (cudaStream_t)stream>>>(
            a, target, (const int*)perm, (const int*)piece_start, n_pieces, (double*)partial);
  });
}

int zmap_stats(const void* args, int target, const void* r, const void* perm,
               const void* piece_start, int n_pieces, void* partial, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_pieces <= 0) return 0;
  return dispatch_kpl(a.k, [&](auto kpl) {
    zmap_stats_kernel<decltype(kpl)::value>
        <<<blocks_for(n_pieces), THREADS, 0, (cudaStream_t)stream>>>(
            a, target, (const float*)r, (const int*)perm, (const int*)piece_start, n_pieces,
            (float*)partial);
  });
}

int zmap_strided(const void* args, int target, const void* r, const void* perm,
                 const void* key_start, int n_keys, void* out, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_keys <= 0) return 0;
  return dispatch_kpl(a.k, [&](auto kpl) {
    zmap_strided_kernel<decltype(kpl)::value>
        <<<blocks_for(n_keys), THREADS, 0, (cudaStream_t)stream>>>(
            a, target, (const float*)r, (const int*)perm, (const int*)key_start, n_keys,
            (float*)out);
  });
}

int zstats_sum(const void* x, int n, void* out, void* stream) {
  sum_kernel<<<1, SUM_THREADS, 0, (cudaStream_t)stream>>>((const float*)x, n, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
