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
//   - zstats_pieces: one warp per piece rebuilds each token's logits in
//     registers and writes the piece's K-vector sum of r (and, for the
//     prior pass, its lse sum).  The piece's key fixes one operand row (the
//     prior row in the prior pass, the word's row in a child's pass), loaded
//     once; the other rows are gathered per token.  The prior pass runs
//     first: it takes each token's softmax and stores the token's max and
//     zmask / sum, 8 bytes, at the token's slot in the first child's order;
//     the children's passes read them back and compute r = exp(x - max) *
//     (zmask / sum) with no reduction: the same operations on the same
//     values, so r is bitwise the prior pass's;
//   - zstats_finish: one warp per key adds its pieces in order and writes
//     the key's row (prior stats) or column (specialized child stats);
//   - zstats_runs: a strided child whose rows base + stride*k are one to
//     one over its (base, k) (the host's test, once per program; DCM-LDA's
//     per-document phi, base = doc * K, stride 1): the host groups its
//     tokens by (base, value) run, and one lane group per run adds the
//     run's r in token order in registers and stores the run's K cells
//     once.  No other run reaches those cells, so no read-modify-write;
//   - zstats_strided: any other strided child: one warp per value column
//     walks that column's tokens in order and adds r into rows base +
//     stride*k of the zeroed table (slow for a hot value);
//   - zstats_sum: one block adds the per-piece lse sums in a fixed order.
// Each pass reads its token streams (prior rows, values, base, masks) in
// its own piece order: the host gathers them through the grouping once per
// program, so consecutive tokens of a piece read consecutive addresses and
// no token waits on a load of its index before the load of its row; the
// prior's grouping orders each key's tokens by the first child's value, so
// a word's tokens in one document read its row once.  A token takes QL
// lanes (16 at K <= 128; Lanes), so a warp works on 32 / QL tokens at once:
// each lane holds a few chunks of 4 topics, read 16 bytes at a time, a
// token's max and sum need log2(QL) shuffles, and its division and log are
// shared by the warp's tokens instead of repeated on all 32 lanes.  A latent
// with one specialized child and no masks (LDA) takes a SIMPLE instance of
// the passes without the general children loop.  The sums run in a fixed
// order: a lane adds its chunks' topics in order, a token's lanes meet in
// a butterfly; a piece's token slots each add their tokens in order and
// then meet in a butterfly.  exp, log and the division are the fast forms
// (at most 2 ulp), far inside the plain version's tolerance.
//
// Bound on the H100: operations.  The call moves its token streams, tables
// and stats once each (188 MB at the 10M-token main path, 0.06 ms at
// 3.35 TB/s) but does about 8 f32 operations per token and topic (0.12 ms
// at 67 TFLOP/s).  In practice the passes are bound by instruction issue
// and by the latency of the gathered rows (N rows of 4K bytes per pass;
// the prior's pass gathers from the 41 MB table of a 102,660-word
// vocabulary, which the L2 does not hold with everything else).  The design
// keeps the gathered tables f32, loads the owner key's row once per piece,
// takes each softmax once, keeps the logits, the key's row and the sums of
// a lane in few enough registers (40 to 60) for 32 or more warps an SM, and
// writes what is read once (statistics, partials) as streaming data.
//
// Segment latents.  The same passes also replace the Pallas TPU kernel
// repro/kernels/fused_zmap.py:zstats_zmap (_phase_logits/_logits_kernel,
// _phase_stats/_stats_kernel, and the extra=/emit_r= use of
// fused_zstats._zstats_call).  A latent whose child carries a zmap (token t
// -> latent instance zmap[t]: an SLDA sentence, a naive Bayes document)
// needs a cross-token sum before its softmax, so it runs in three phases:
//   1. zmap_logits: the host groups each zmap child's tokens by instance;
//      a few lanes per piece sum mask * message in f64, tokens in order.
//      An instance of one piece (an SLDA sentence) has its row of the
//      (n_latent, K) f32 logits written by that piece, rounded once; an
//      instance of several (a naive Bayes document) gets f64 partials that
//      zstats_finish64 adds in order; children in order, a later one adding
//      to the row;
//   2a. the prior pass above over the latent instances, with those logits
//      as `extra` after the prior row, writes each instance's r row once
//      (`r_out`) besides the prior stats, the lse and the stats of any
//      child without a zmap;
//   2b. per zmap child, by the pass the host plan chose for it:
//      zmap_stats (a specialized child: SLDA's phi): the host groups its
//      tokens by value; a few lanes per piece sum mask * r[zmap] and
//      zstats_finish writes the value's column of the stats;
//      zmap_runs (a strided child whose rows base + stride*k are one to one
//      over its (base, k): DCM-SLDA's per-document phi, base = doc * K,
//      stride 1): the host groups its tokens by (base, value) run, and one
//      lane group per run sums mask * r[zmap] in registers and stores the
//      run's K cells once into the zeroed table;
//      zmap_strided (a strided child whose rows collide): a warp walks each
//      value column in token order, adding into the zeroed table.  Both
//      strided passes round each product, then the add, so their cells are
//      bitwise equal where both apply.
// Bound on the H100 at the SLDA main path (10M tokens, 1.44M sentences,
// K = 100): operations, about 0.08 ms, just above the 0.06 ms that its
// inputs and outputs take at 3.35 TB/s.  The (n_latent, K) logits and r
// are intermediates of 0.58 GB each, written and read once more, and phase
// 1 and 2b each gather a K-row per token (the message from a 41 MB table, r
// from a 574 MB one: 4 GB each, about 1.2 ms at 3.35 TB/s for r, which the
// L2 does not hold); the design accepts that for owner passes without
// atomics, and keeps several gathered rows per piece in flight.
//
// Tables arrive as f32 Elog values (the wrapper's Triton pre-pass computes
// them from f32 or bf16 concentrations); accumulation is f32.  K may be
// anything from 1 to 1024 (KPL, a template parameter: it sets the lanes per
// token of the flat passes and per piece or run of the segment ones, Lanes;
// the per-column strided segment pass keeps KPL topics a lane).
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
  // The flat passes read their token streams (prior_rows, zmask and the
  // children's values, base and mask above) at position t of the pass's own
  // piece order; these say where that token lies elsewhere:
  const int* tok;           // (N,) its index in the call's order (extra, r_out), or null: t
  const int* spos;          // (N,) its slot in `stats`, or null: t
  float2* stats;            // (N,) (max, zmask / sum) of each token's softmax, written
                            // by the prior pass and read by the children's, or null
  int vec;                  // K % 4 == 0 and every K-row table 16-byte aligned:
                            // the flat passes load 16 bytes at a time
};

// The flat passes' lane layout: a token takes QL lanes, so a warp holds
// TPW = 32 / QL tokens at once (2 at K = 100).  Lane q of a token holds the
// float4 chunks c = i * QL + q (i < CH) of its K-vector, topics 4c .. 4c + 3,
// loaded as one 16-byte load when K % 4 == 0 and as 4 scalar loads
// otherwise.  A token's max and sum take log2(QL) shuffles among its own
// lanes, and its division and log are shared by the TPW tokens of one warp
// instruction.  QL * CH * 4 >= 32 * KPL >= K.  Topics past K carry -inf
// logits (the prior row is read with -inf past K, every other row with 0),
// so the max, the exp and the sums need no test of the topic: exp(-inf)
// adds 0.  A lane keeps CH * 4 logits, its row of the piece's key and its
// sums in some 60 registers.
template <int KPL>
struct Lanes {
  static constexpr int QL = KPL >= 8 ? 32 : 4 * KPL;   // lanes per token
  static constexpr int CH = 32 * KPL / (4 * QL);       // float4 chunks per lane
};
#define FLAT_WARPS 4                   // warps per block of the flat and segment passes

// Row `row` of K floats into chunks (fill past K).  The loop skips a chunk
// that no lane of the warp holds.
template <int QL, int CH>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int q, int k, bool vec,
                                         float fill, float (&r)[CH][4]) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = i * QL + q;
    if (4 * QL * i < k) {
      if (vec) {
        const float4 v = 4 * c < k ? *reinterpret_cast<const float4*>(row + 4 * c)
                                   : make_float4(fill, fill, fill, fill);
        r[i][0] = v.x; r[i][1] = v.y; r[i][2] = v.z; r[i][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[i][e] = 4 * c + e < k ? row[4 * c + e] : fill;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[i][e] = fill;
    }
  }
}

// Topic index of chunk i, element e of lane q; below K where it is real.
template <int QL>
__device__ __forceinline__ int topic(int i, int q, int e) { return 4 * (i * QL + q) + e; }

// Token t's logits (the lane's chunks; -inf past K): the prior row, then
// (EXTRA, a segment latent's prior pass) the instance's row of the extra
// logits, then each child's masked message, in that order.  The operand row
// of `fixed` (-1: the prior, read with -inf past K; c >= 0: child c, read
// with 0 past K) is `frow`, the row the piece's owner key selects, loaded
// once per piece; every other row is gathered.  fixed = -2 gathers every row.
template <int QL, int CH, bool EXTRA, bool SIMPLE = false>
__device__ __forceinline__ void token_logits(const ZArgs& a, int t, int q, bool vec, int fixed,
                                             const float (&frow)[CH][4], float (&x)[CH][4]) {
  const int k = a.k;
  if constexpr (SIMPLE) {
    // one specialized child without a mask: the prior row plus its row
    float r[CH][4];
    if (fixed == -1)
      load_row<QL, CH>(a.c[0].table + (size_t)a.c[0].values[t] * k, q, k, vec, 0.0f, r);
    else
      load_row<QL, CH>(a.prior + (size_t)a.prior_rows[t] * k, q, k, vec, -INFINITY, r);
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][e] = fixed == -1 ? frow[i][e] + r[i][e] : r[i][e] + frow[i][e];
    return;
  }
  if (fixed == -1) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][e] = frow[i][e];
  } else {
    load_row<QL, CH>(a.prior + (size_t)a.prior_rows[t] * k, q, k, vec, -INFINITY, x);
  }
  if constexpr (EXTRA) {
    const int i0 = a.tok ? a.tok[t] : t;
    float ex[CH][4];
    load_row<QL, CH>(a.extra + (size_t)i0 * k, q, k, vec, 0.0f, ex);
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][e] += ex[i][e];
  }
  for (int c = 0; c < a.n_children; ++c) {
    const ZChildArgs& ch = a.c[c];
    const float mk = ch.mask ? ch.mask[t] : 1.0f;
    if (c == fixed) {
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][e] += frow[i][e] * mk;
    } else if (ch.specialized) {
      float r[CH][4];
      load_row<QL, CH>(ch.table + (size_t)ch.values[t] * k, q, k, vec, 0.0f, r);
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][e] += r[i][e] * mk;
    } else {
      const int v = ch.values[t];
      const int b = ch.base ? ch.base[t] : 0;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = topic<QL>(i, q, e);
          if (kk < k) x[i][e] += ch.table[(size_t)(b + ch.stride * kk) * ch.kf + v] * mk;
        }
    }
  }
}

// Sum (MAX: max) of v over the QL lanes of a token, butterfly order.
template <int QL, bool MAX>
__device__ __forceinline__ float token_reduce(float v) {
#pragma unroll
  for (int o = QL / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// Logits -> responsibilities in place (times zm); sets the token's max and
// sum (the same on all its lanes) and returns zm / sum.  r is rounded before
// any sum takes it.  The fast exp and division (at most 2 ulp) keep the
// outputs far inside the plain version's tolerance.
template <int QL, int CH>
__device__ __forceinline__ float token_softmax(float (&x)[CH][4], float zm, float& m,
                                               float& sum) {
  m = -INFINITY;
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) m = fmaxf(m, x[i][e]);
  m = token_reduce<QL, true>(m);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[i][e] = __expf(x[i][e] - m);
      s += x[i][e];
    }
  sum = token_reduce<QL, false>(s);
  const float scale = __fdividef(zm, sum);
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = __fmul_rn(x[i][e], scale);
  return scale;
}

// Responsibilities from logits and the (max, zm / sum) the prior pass
// stored: the same operations as token_softmax, no reduction, so r is
// bitwise the prior pass's.
template <int CH>
__device__ __forceinline__ void token_reuse(float (&x)[CH][4], float2 st) {
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = __fmul_rn(__expf(x[i][e] - st.x), st.y);
}

// One warp per piece: the piece's sum of r (PRIOR: the prior's pass, which
// also sums lse, stores each token's max and zm / sum for the children's
// passes and, for a segment latent (EXTRA), writes each instance's r row to
// r_out: every instance lies in exactly one piece of that pass) or of
// mask_target * r (a specialized child's pass, r rebuilt from the stored
// max and zm / sum).  All tokens of a piece share the owner key
// piece_key[piece], so its table row is loaded once.  The piece's tokens
// are stream positions piece_start[piece] .. piece_start[piece + 1] - 1;
// token slot g of the warp takes t0 + g, t0 + g + TPW, ... and sums its own
// tokens in that order, then the slots' sums meet in a butterfly.  What is
// written once (the statistics, the partials) is stored as streaming data,
// so that the gathered tables keep their place in L2.
template <int KPL, bool EXTRA, bool PRIOR, bool SIMPLE>
__global__ void pieces_kernel(ZArgs a, int target, const int* __restrict__ piece_key,
                              const int* __restrict__ piece_start, int n_pieces,
                              float* __restrict__ partial, float* __restrict__ lse_part) {
  constexpr int QL = Lanes<KPL>::QL, CH = Lanes<KPL>::CH, TPW = 32 / QL;
  const int warp = blockIdx.x * FLAT_WARPS + (threadIdx.x >> 5);
  if (warp >= n_pieces) return;
  const int lane = threadIdx.x & 31, q = lane % QL, g = lane / QL;
  const int k = a.k;
  const bool vec = a.vec != 0;
  const int t0 = piece_start[warp], t1 = piece_start[warp + 1];
  const int key = piece_key[warp];
  float frow[CH][4], acc[CH][4];
  if (PRIOR)
    load_row<QL, CH>(a.prior + (size_t)key * k, q, k, vec, -INFINITY, frow);
  else
    load_row<QL, CH>(a.c[target].table + (size_t)key * k, q, k, vec, 0.0f, frow);
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  const float* wmask = PRIOR || SIMPLE ? nullptr : a.c[target].mask;
  float lse_acc = 0.0f;
  for (int tb = t0; tb < t1; tb += TPW) {
    const bool live = tb + g < t1;
    const int t = live ? tb + g : t0;  // an idle slot repeats t0 and drops it
    float x[CH][4];
    token_logits<QL, CH, EXTRA, SIMPLE>(a, t, q, vec, PRIOR ? -1 : target, frow, x);
    if constexpr (PRIOR) {
      const float zm = !SIMPLE && a.zmask ? a.zmask[t] : 1.0f;
      float m, sum;
      const float scale = token_softmax<QL, CH>(x, zm, m, sum);
      if (live) {
        lse_acc += (m + __logf(sum)) * zm;
        if (a.stats && q == 0)
          __stcs(a.stats + (a.spos ? a.spos[t] : t), make_float2(m, scale));
        if (EXTRA) {
          float* rrow = a.r_out + (size_t)(a.tok ? a.tok[t] : t) * k;
#pragma unroll
          for (int i = 0; i < CH; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (topic<QL>(i, q, e) < k) __stcs(rrow + topic<QL>(i, q, e), x[i][e]);
        }
#pragma unroll
        for (int i = 0; i < CH; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += x[i][e];
      }
    } else {
      token_reuse<CH>(x, a.stats[a.spos ? a.spos[t] : t]);
      if (live) {
        const float w = wmask ? wmask[t] : 1.0f;
#pragma unroll
        for (int i = 0; i < CH; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += x[i][e] * w;
      }
    }
  }
  // the token slots' sums meet in a butterfly
#pragma unroll
  for (int o = 16; o >= QL; o >>= 1) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
    lse_acc += __shfl_xor_sync(0xffffffffu, lse_acc, o);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (topic<QL>(i, q, e) < k)
          __stcs(partial + (size_t)warp * k + topic<QL>(i, q, e), acc[i][e]);
  }
  if (PRIOR && lane == 0) lse_part[warp] = lse_acc;
}

// One warp per listed key w (key keys[w], or w where keys is null): add its
// pieces key_pieces[w] .. key_pieces[w + 1] - 1 in order, in T; write
// out[key, kk] at key * stride_key + kk * stride_k, rounded once to f32
// (add != 0: add to it).  Keys without pieces write zeros (add nothing).
template <typename T>
__global__ void finish_kernel(const T* __restrict__ partial, const int* __restrict__ keys,
                              const int* __restrict__ key_pieces, int n_keys, int k,
                              float* __restrict__ out, long long stride_key,
                              long long stride_k, int add) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_keys) return;
  const long long key = keys ? keys[warp] : warp;
  const int p0 = key_pieces[warp], p1 = key_pieces[warp + 1];
  for (int kk = lane; kk < k; kk += 32) {
    T acc = 0;
    for (int p = p0; p < p1; ++p) acc += __ldcs(partial + (size_t)p * k + kk);
    float* o = out + key * stride_key + kk * stride_k;
    *o = add ? (float)(*o + acc) : (float)acc;
  }
}

// The same sums for a column owner (out[kk * stride_k + key], a specialized
// child's (K, V) stats): a block of 32 warps takes 32 keys, warp w adds key
// w's pieces in order for 32 topics at a time, and the block writes the
// (32 topics, 32 keys) tile through shared memory as rows of 32 consecutive
// keys instead of one 4-byte store per (key, topic).
__global__ void finish_cols_kernel(const float* __restrict__ partial,
                                   const int* __restrict__ key_pieces, int n_keys, int k,
                                   float* __restrict__ out, long long stride_k) {
  __shared__ float tile[32][33];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * 32, key = key0 + w;
  const int p0 = key < n_keys ? key_pieces[key] : 0;
  const int p1 = key < n_keys ? key_pieces[key + 1] : 0;
  for (int kk0 = 0; kk0 < k; kk0 += 32) {
    float acc = 0.0f;
    if (kk0 + lane < k)
      for (int p = p0; p < p1; ++p) acc += __ldcs(partial + (size_t)p * k + kk0 + lane);
    tile[w][lane] = acc;
    __syncthreads();
    const int kk = kk0 + w, col = key0 + lane;
    if (kk < k && col < n_keys) out[kk * stride_k + col] = tile[lane][w];
    __syncthreads();
  }
}

// One warp per value column of a strided child: walk the column's tokens
// (stream positions key_start[col] ..) TPW at a time and add, token after
// token in order, mask * r into rows base + stride * k of out (zeroed); r is
// rebuilt from the stored max and zm / sum.
template <int KPL, bool EXTRA>
__global__ void strided_kernel(ZArgs a, int target, const int* __restrict__ key_start,
                               int n_keys, float* __restrict__ out) {
  constexpr int QL = Lanes<KPL>::QL, CH = Lanes<KPL>::CH, TPW = 32 / QL;
  const int warp = blockIdx.x * FLAT_WARPS + (threadIdx.x >> 5);
  if (warp >= n_keys) return;
  const int lane = threadIdx.x & 31, q = lane % QL, g = lane / QL;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const bool vec = a.vec != 0;
  const int t1 = key_start[warp + 1];
  float none[CH][4];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) none[i][e] = 0.0f;
  for (int tb = key_start[warp]; tb < t1; tb += TPW) {
    const bool live = tb + g < t1;
    const int t = live ? tb + g : tb;
    float r[CH][4];
    token_logits<QL, CH, EXTRA>(a, t, q, vec, -2, none, r);
    token_reuse<CH>(r, a.stats[a.spos ? a.spos[t] : t]);
    const float w = ch.mask ? ch.mask[t] : 1.0f;
    const int b = ch.base ? ch.base[t] : 0;
    for (int u = 0; u < TPW && tb + u < t1; ++u) {
      if (g == u) {
#pragma unroll
        for (int i = 0; i < CH; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = topic<QL>(i, q, e);
            if (kk < k) out[(size_t)(b + ch.stride * kk) * ch.kf + warp] += r[i][e] * w;
          }
      }
      __syncwarp();   // rows may repeat across tokens: keep token order
    }
  }
}

// A strided child's message row for value v at rows b + stride * k (the
// lane's chunks; 0 past K).
template <int QL, int CH>
__device__ __forceinline__ void strided_row(const ZChildArgs& ch, int v, int b, int q, int k,
                                            float (&x)[CH][4]) {
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = topic<QL>(i, q, e);
      x[i][e] = kk < k ? ch.table[(size_t)(b + ch.stride * kk) * ch.kf + v] : 0.0f;
    }
}

// One run of a strided child whose rows base + stride * k are one to one
// over its (base, k): the run's tokens (stream positions key_start[run] ..)
// share one base b and one value v, so the run alone reaches its K cells
// (b + stride * k, v).  Lane q of the run's lane group loads the run's
// message row once, walks the tokens in order (each token's logits as
// token_logits builds them: the same values added in the same order; r from
// the stored max and zm / sum, token_reuse) adding mask * r in registers,
// and stores its cells once.  strided_kernel adds each product, rounded, into the
// zeroed table (its add reads the table, so it does not contract: FMUL then
// FADD), and so does this: each cell sums the same terms in the same order
// from the same 0, bitwise.
template <int QL, int CH, bool EXTRA>
__device__ __forceinline__ void run_cells(const ZArgs& a, int target,
                                          const int* __restrict__ key_start, int run, int q,
                                          float* __restrict__ out) {
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const bool vec = a.vec != 0;
  const int t0 = key_start[run], t1 = key_start[run + 1];
  const int v = ch.values[t0], b = ch.base ? ch.base[t0] : 0;
  float mrow[CH][4], acc[CH][4];
  strided_row<QL, CH>(ch, v, b, q, k, mrow);
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    float r[CH][4];
    token_logits<QL, CH, EXTRA>(a, t, q, vec, target, mrow, r);
    token_reuse<CH>(r, a.stats[a.spos ? a.spos[t] : t]);
    const float w = ch.mask ? ch.mask[t] : 1.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(r[i][e], w));
  }
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = topic<QL>(i, q, e);
      if (kk < k) out[(size_t)(b + ch.stride * kk) * ch.kf + v] = acc[i][e];
    }
}

// The runs pass over a zeroed table: one lane group (QL lanes, the flat
// passes' token layout) per run, PPW runs a warp.  The groups of a warp
// share no shuffle: each runs as long as its own run.  (A block per base
// that also wrote the zeros of the base's rows, whole rows coalesced, took
// longer on the H100 at DCM-LDA than the zero fill and this together.)
template <int KPL, bool EXTRA>
__global__ void runs_kernel(ZArgs a, int target, const int* __restrict__ key_start, int n_runs,
                            float* __restrict__ out) {
  constexpr int QL = Lanes<KPL>::QL, CH = Lanes<KPL>::CH, PPW = 32 / QL;
  const int warp = blockIdx.x * FLAT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, run = warp * PPW + lane / QL;
  if (run < n_runs) run_cells<QL, CH, EXTRA>(a, target, key_start, run, lane % QL, out);
}

// --- segment latents (a child with a zmap: SLDA sentences, naive Bayes
// documents).  The ZArgs of these passes hold the zmap children only, and
// each pass reads child `target`'s token streams (values, base, mask, zmap)
// at position t of its own piece order: the host gathers them through the
// pass's grouping once per program (the call's arrays where the grouping
// keeps the call's order), so no pass reads a permutation.
//
// Phase 1 and phase 2b share one walk.  A piece takes QL lanes, the flat
// passes' token layout (Lanes: 16 at K = 100, two float4 chunks a lane), so
// a warp owns PPW = 32 / QL pieces (2 at K = 100) and every lane of a piece
// holds the same topics for the piece's whole run.  A lane loads its
// piece's bounds, and its route where there is one, at the start, all at
// once.  The piece's tokens come QL at a time: lane q loads token q's
// stream entries (coalesced, streaming loads), then the piece takes
// U = SegRows tokens at a time, each lane gathering its chunks of those rows
// before it adds any.  The adds run in token order, one accumulator per
// topic, so each (piece, topic) sum has the order of a walk one token at a
// time.  The pieces of a warp run as many steps as the longest of them (its
// shuffles need the whole warp); a step past a piece's own end loads and
// adds nothing.  Registers rule the design: SLDA's sentences are 7 tokens,
// so a piece is a short chain of dependent loads and the pass lives on
// warps in flight; 2 rows in flight (64 registers at K = 100) beat 1 and 4.
template <int CH>
struct SegRows {   // rows in flight per piece
  static constexpr int value = CH <= 4 ? 2 : 1;
};

// A lane's stream entries for token t of a piece of `len` tokens at t0:
// past the piece's end an index of 0 (a row that exists), base 0, weight 1.
struct Entry {
  int idx, base;
  float w;
};

__device__ __forceinline__ Entry load_entry(const int* __restrict__ idx,
                                            const int* __restrict__ base,
                                            const float* __restrict__ w, int t0, int len,
                                            int t) {
  const bool mine = t < len;
  return {mine ? __ldcs(idx + t0 + t) : 0, mine && base ? __ldcs(base + t0 + t) : 0,
          mine && w ? __ldcs(w + t0 + t) : 1.0f};
}

// Largest v over the PPW pieces of a warp (lanes QL apart).
template <int QL>
__device__ __forceinline__ int pieces_max(int v) {
#pragma unroll
  for (int o = QL; o < 32; o <<= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The walk of one piece (t0, len; `most` the warp's longest): for each of
// its tokens in order, ROW(x, idx, base) gathers the token's row into the
// lane's chunks and ADD(x, w) adds it.  A macro, so each kernel keeps its
// own accumulators and row gather inline.
#define SEG_WALK(IDX, BASE, W, ROW, ADD)                                            \
  {                                                                                 \
    constexpr int U = SegRows<CH>::value;                                           \
    for (int tb = 0; tb < most; tb += QL) {                                         \
      const Entry cur = load_entry(IDX, BASE, W, t0, len, tb + q);                  \
      _Pragma("unroll") for (int u0 = 0; u0 < QL; u0 += U) {                        \
        if (tb + u0 >= most) break;                                                 \
        float x[U][CH][4];                                                          \
        _Pragma("unroll") for (int u = 0; u < U; ++u) {                             \
          const int iu = __shfl_sync(0xffffffffu, cur.idx, u0 + u, QL);             \
          const int bu = __shfl_sync(0xffffffffu, cur.base, u0 + u, QL);            \
          if (tb + u0 + u < len) { ROW(x[u], iu, bu); }                             \
        }                                                                           \
        _Pragma("unroll") for (int u = 0; u < U; ++u) {                             \
          const float wu = __shfl_sync(0xffffffffu, cur.w, u0 + u, QL);             \
          if (tb + u0 + u < len) { ADD(x[u], wu); }                                 \
        }                                                                           \
      }                                                                             \
    }                                                                               \
  }

// Phase 1, one lane group per piece of child `target`'s tokens grouped by
// latent instance (piece_key: the instance): the piece's sum of mask *
// message, in f64, tokens in order.  A naive Bayes document's logits reach
// thousands of nats, where f32 sums of its few hundred messages lose the
// hundredths of a nat that decide r for a document near a tie between two
// classes.  A piece that is its instance's only piece (slot < 0: every SLDA
// sentence) writes the instance's f32 logits row itself, (float)sum, or
// (float)(row + sum) for a later zmap child (add): what zstats_finish64
// would write from its one partial, bit for bit.  The piece of an instance
// of several pieces writes its f64 partial at row `slot`, and
// zstats_finish64 adds that instance's partials in order.
template <int KPL>
__global__ void zmap_logits_kernel(ZArgs a, int target, const int* __restrict__ piece_key,
                                   const int* __restrict__ piece_start,
                                   const int* __restrict__ slot, int n_pieces,
                                   double* __restrict__ partial, float* __restrict__ out,
                                   int add) {
  constexpr int QL = Lanes<KPL>::QL, CH = Lanes<KPL>::CH, PPW = 32 / QL;
  const int warp = blockIdx.x * FLAT_WARPS + (threadIdx.x >> 5);
  if (warp * PPW >= n_pieces) return;
  const int lane = threadIdx.x & 31, q = lane % QL, p = warp * PPW + lane / QL;
  const bool own = p < n_pieces;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const bool vec = a.vec != 0;
  const int t0 = own ? piece_start[p] : 0;
  const int len = own ? piece_start[p + 1] - t0 : 0;
  const int s = own ? slot[p] : 0;
  const int key = own ? piece_key[p] : 0;
  const int most = pieces_max<QL>(len);
  double acc[CH][4];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0;
#define LOGITS_ROW(X, V, B)                                                   \
  if (ch.specialized) load_row<QL, CH>(ch.table + (size_t)(V) * k, q, k, vec, 0.0f, X); \
  else strided_row<QL, CH>(ch, V, B, q, k, X)
#define LOGITS_ADD(X, M)                                                      \
  _Pragma("unroll") for (int i = 0; i < CH; ++i)                              \
    _Pragma("unroll") for (int e = 0; e < 4; ++e) acc[i][e] += (double)X[i][e] * (M)
  SEG_WALK(ch.values, ch.base, ch.mask, LOGITS_ROW, LOGITS_ADD)
#undef LOGITS_ROW
#undef LOGITS_ADD
  if (!own) return;
  if (s >= 0) {
    double* d = partial + (size_t)s * k;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (topic<QL>(i, q, e) < k) d[topic<QL>(i, q, e)] = acc[i][e];
    return;
  }
  float* o = out + (size_t)key * k;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = i * QL + q;
    if (4 * c >= k) continue;
    if (vec) {
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (add) w = *reinterpret_cast<const float4*>(o + 4 * c);
      w.x = add ? (float)(w.x + acc[i][0]) : (float)acc[i][0];
      w.y = add ? (float)(w.y + acc[i][1]) : (float)acc[i][1];
      w.z = add ? (float)(w.z + acc[i][2]) : (float)acc[i][2];
      w.w = add ? (float)(w.w + acc[i][3]) : (float)acc[i][3];
      __stcs(reinterpret_cast<float4*>(o + 4 * c), w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < k) o[4 * c + e] = add ? (float)(o[4 * c + e] + acc[i][e]) : (float)acc[i][e];
    }
  }
}

// Phase 1 with one warp per piece, the lanes over topics (lane + 32 j, KPL
// topics a lane) and the tokens one at a time: the same sums, route and
// writes as zmap_logits_kernel, for instances of several pieces (naive Bayes
// documents of a few hundred tokens, K = 20).  There a lane group of 4
// walks 256 tokens in a row beside the short last piece of a document, and
// a warp a piece keeps 8 times as many pieces going.
template <int KPL>
__global__ void zmap_logits_warp_kernel(ZArgs a, int target, const int* __restrict__ piece_key,
                                        const int* __restrict__ piece_start,
                                        const int* __restrict__ slot, int n_pieces,
                                        double* __restrict__ partial, float* __restrict__ out,
                                        int add) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_pieces) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const int t1 = piece_start[warp + 1], s = slot[warp], key = piece_key[warp];
  double acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) acc[j] = 0.0;
  for (int t = piece_start[warp]; t < t1; ++t) {
    const int v = ch.values[t];
    const float mk = ch.mask ? ch.mask[t] : 1.0f;
    float e[KPL];
    if (ch.specialized) {
      const float* row = ch.table + (size_t)v * k;
#pragma unroll
      for (int j = 0; j < KPL; ++j) e[j] = lane + 32 * j < k ? row[lane + 32 * j] : 0.0f;
    } else {
      const int b = ch.base ? ch.base[t] : 0;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kk = lane + 32 * j;
        e[j] = kk < k ? ch.table[(size_t)(b + ch.stride * kk) * ch.kf + v] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc[j] += (double)e[j] * mk;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int kk = lane + 32 * j;
    if (kk >= k) continue;
    if (s >= 0) {
      partial[(size_t)s * k + kk] = acc[j];
    } else {
      float* o = out + (size_t)key * k + kk;
      *o = add ? (float)(*o + acc[j]) : (float)acc[j];
    }
  }
}

// Phase 2b, one lane group per piece of a specialized child's tokens grouped
// by value: the piece's sum of mask * r[zmap], f32, tokens in order.  Each
// token gathers one K-row of r from the (n_latent, K) table, which the L2
// does not hold at SLDA's 1.44M sentences: the pass is bound by the gathered
// bytes; the walk reads the piece's instance indices QL at a time and
// gathers the rows 16 bytes a load (vec).
template <int KPL>
__global__ void zmap_stats_kernel(ZArgs a, int target, const float* __restrict__ r,
                                  const int* __restrict__ piece_start, int n_pieces,
                                  float* __restrict__ partial, int vec) {
  constexpr int QL = Lanes<KPL>::QL, CH = Lanes<KPL>::CH, PPW = 32 / QL;
  const int warp = blockIdx.x * FLAT_WARPS + (threadIdx.x >> 5);
  if (warp * PPW >= n_pieces) return;
  const int lane = threadIdx.x & 31, q = lane % QL, p = warp * PPW + lane / QL;
  const bool own = p < n_pieces;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const int t0 = own ? piece_start[p] : 0;
  const int len = own ? piece_start[p + 1] - t0 : 0;
  const int most = pieces_max<QL>(len);
  float acc[CH][4];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#define STATS_ROW(X, Z, B) load_row<QL, CH>(r + (size_t)(Z) * k, q, k, vec != 0, 0.0f, X)
#define STATS_ADD(X, W)                                                       \
  _Pragma("unroll") for (int i = 0; i < CH; ++i)                              \
    _Pragma("unroll") for (int e = 0; e < 4; ++e) acc[i][e] += X[i][e] * (W)
  SEG_WALK(ch.zmap, (const int*)nullptr, ch.mask, STATS_ROW, STATS_ADD)
#undef STATS_ROW
#undef STATS_ADD
  if (!own) return;
  float* d = partial + (size_t)p * k;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = i * QL + q;
    if (4 * c >= k) continue;
    if (vec) {
      *reinterpret_cast<float4*>(d + 4 * c) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < k) d[4 * c + e] = acc[i][e];
    }
  }
}

// Phase 2b of a strided child whose rows collide (two bases stride * m apart,
// 0 < |m| < K: the host's rows_one_to_one test fails): one warp per value
// column walks the column's tokens in order and adds mask * r[zmap] into
// rows base + stride * k of out (zeroed), each product rounded, then the add,
// as zmap_runs_kernel sums the same terms.  Written `out += r * w` it compiled
// to one FFMA a cell on the H100 (cuobjdump): a fused multiply-add rounds
// once, so with a fractional mask its cells differed from a rounded product
// then an add in the last bits (with masks of 0 and 1 the two agree).  A hot
// value's column is one serial chain of read-modify-writes; a child whose
// rows are one to one takes zmap_runs_kernel instead.  It reads the pass's
// streams.
template <int KPL>
__global__ void zmap_strided_kernel(ZArgs a, int target, const float* __restrict__ r,
                                    const int* __restrict__ key_start, int n_keys,
                                    float* __restrict__ out) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_keys) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const int t1 = key_start[warp + 1];
  for (int t = key_start[warp]; t < t1; ++t) {
    const float w = ch.mask ? ch.mask[t] : 1.0f;
    const int b = ch.base ? ch.base[t] : 0;
    const float* rrow = r + (size_t)ch.zmap[t] * k;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int kk = lane + 32 * j;
      if (kk < k) {
        float* o = out + (size_t)(b + ch.stride * kk) * ch.kf + warp;
        *o = __fadd_rn(*o, __fmul_rn(rrow[kk], w));
      }
    }
    __syncwarp();   // rows may repeat across tokens and lanes: keep token order
  }
}

// Phase 2b of a strided child whose rows base + stride * k are one to one
// over its (base, k) (SLDA's sentence topics over DCM-LDA's per-document phi:
// base = doc * K, stride 1).  The host groups the child's tokens by (base,
// value) run, runs in (base, value) order, each run's tokens in their
// original order (fused_zstats.group_runs), and gathers the pass's streams
// (values, base, mask, zmap) in run order.  One lane group (QL lanes, the
// segment passes' layout) owns each run, PPW runs a warp: lane q walks the
// run's tokens, gathers its chunks of r[zmap[t]] (16 bytes a load where vec),
// adds mask * r in registers, a product rounded then the add, and stores its
// cells (b + stride * k, v) once into the zeroed table.  No other run reaches
// those cells, so there is no read-modify-write and no serial chain down a hot
// value's column.  Each cell sums the terms of zmap_strided_kernel, in the
// same order (a column's tokens in their original order, those of one base
// among them) from the same 0, with the same roundings: bitwise equal.  The
// groups of a warp share no shuffle: each runs as long as its own run.  A run
// is one word's occurrences in one document, so consecutive tokens share an r
// row only where the word repeats within a sentence; the loads are not
// deduplicated.
template <int KPL>
__global__ void zmap_runs_kernel(ZArgs a, int target, const float* __restrict__ r,
                                 const int* __restrict__ key_start, int n_runs,
                                 float* __restrict__ out, int vec) {
  constexpr int QL = Lanes<KPL>::QL, CH = Lanes<KPL>::CH, PPW = 32 / QL;
  const int warp = blockIdx.x * FLAT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, q = lane % QL, run = warp * PPW + lane / QL;
  if (run >= n_runs) return;
  const ZChildArgs& ch = a.c[target];
  const int k = a.k;
  const int t0 = key_start[run], t1 = key_start[run + 1];
  const int v = ch.values[t0], b = ch.base ? ch.base[t0] : 0;
  float acc[CH][4];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const float w = ch.mask ? __ldcs(ch.mask + t) : 1.0f;
    float x[CH][4];
    load_row<QL, CH>(r + (size_t)__ldcs(ch.zmap + t) * k, q, k, vec != 0, 0.0f, x);
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(x[i][e], w));
  }
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = topic<QL>(i, q, e);
      if (kk < k) __stcs(out + (size_t)(b + ch.stride * kk) * ch.kf + v, acc[i][e]);
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

// Lanes per token (flat passes) or per piece (segment passes) at K.
static int kpl_lanes(int k) {
  const int kpl = kpl_of(k);
  return kpl >= 8 ? 32 : 4 * kpl;
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

int zstats_pieces(const void* args, int target, const void* piece_key,
                  const void* piece_start, int n_pieces, void* partial, void* lse_part,
                  void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_pieces <= 0) return 0;
  const unsigned grid = (unsigned)((n_pieces + FLAT_WARPS - 1) / FLAT_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_kpl(a.k, [&](auto kpl) {
    constexpr int KPL = decltype(kpl)::value;
    auto go = [&](auto kernel) {
      kernel<<<grid, 32 * FLAT_WARPS, 0, s>>>(a, target, (const int*)piece_key,
                                      (const int*)piece_start, n_pieces, (float*)partial,
                                      (float*)lse_part);
    };
    // SIMPLE: one specialized child, no mask, no zmask, no extra logits
    const bool simple = !a.extra && !a.zmask && a.n_children == 1 && a.c[0].specialized &&
                        !a.c[0].mask;
    if (a.extra) {
      if (target < 0) go(pieces_kernel<KPL, true, true, false>);
      else go(pieces_kernel<KPL, true, false, false>);
    } else if (simple) {
      if (target < 0) go(pieces_kernel<KPL, false, true, true>);
      else go(pieces_kernel<KPL, false, false, true>);
    } else {
      if (target < 0) go(pieces_kernel<KPL, false, true, false>);
      else go(pieces_kernel<KPL, false, false, false>);
    }
  });
}

int zstats_finish(const void* partial, const void* key_pieces, int n_keys, int k, void* out,
                  long long stride_key, long long stride_k, int add, void* stream) {
  if (n_keys <= 0) return 0;
  if (stride_key == 1 && !add) {       // columns: the tiled, coalesced writer
    finish_cols_kernel<<<(unsigned)((n_keys + 31) / 32), 1024, 0, (cudaStream_t)stream>>>(
        (const float*)partial, (const int*)key_pieces, n_keys, k, (float*)out, stride_k);
    return (int)cudaGetLastError();
  }
  finish_kernel<float><<<blocks_for(n_keys), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, nullptr, (const int*)key_pieces, n_keys, k, (float*)out,
      stride_key, stride_k, add);
  return (int)cudaGetLastError();
}

// The finish of phase 1 over f64 partials, for the n_keys instances `keys`
// (those of several pieces, or of none): key keys[w] adds partial rows
// key_pieces[w] .. key_pieces[w + 1] - 1.
int zstats_finish64(const void* partial, const void* keys, const void* key_pieces, int n_keys,
                    int k, void* out, long long stride_key, long long stride_k, int add,
                    void* stream) {
  if (n_keys <= 0) return 0;
  finish_kernel<double><<<blocks_for(n_keys), THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)partial, (const int*)keys, (const int*)key_pieces, n_keys, k, (float*)out,
      stride_key, stride_k, add);
  return (int)cudaGetLastError();
}

int zstats_strided(const void* args, int target, const void* key_start, int n_keys,
                   void* out, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_keys <= 0) return 0;
  const unsigned grid = (unsigned)((n_keys + FLAT_WARPS - 1) / FLAT_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_kpl(a.k, [&](auto kpl) {
    constexpr int KPL = decltype(kpl)::value;
    if (a.extra)
      strided_kernel<KPL, true><<<grid, 32 * FLAT_WARPS, 0, s>>>(
          a, target, (const int*)key_start, n_keys, (float*)out);
    else
      strided_kernel<KPL, false><<<grid, 32 * FLAT_WARPS, 0, s>>>(
          a, target, (const int*)key_start, n_keys, (float*)out);
  });
}

// Blocks of the segment passes for n_pieces pieces, PPW to a warp.
static unsigned seg_blocks(int n_pieces, int k) {
  const int ppw = 32 / kpl_lanes(k);
  const int warps = (n_pieces + ppw - 1) / ppw;
  return (unsigned)((warps + FLAT_WARPS - 1) / FLAT_WARPS);
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int zstats_runs(const void* args, int target, const void* key_start, int n_runs, void* out,
                void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_runs <= 0) return 0;
  const unsigned grid = seg_blocks(n_runs, a.k);
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_kpl(a.k, [&](auto kpl) {
    constexpr int KPL = decltype(kpl)::value;
    auto go = [&](auto kernel) {
      kernel<<<grid, 32 * FLAT_WARPS, 0, s>>>(a, target, (const int*)key_start, n_runs,
                                              (float*)out);
    };
    if (a.extra) go(runs_kernel<KPL, true>);
    else go(runs_kernel<KPL, false>);
  });
}

// warp != 0: zmap_logits_warp_kernel, a warp per piece.
int zmap_logits(const void* args, int target, const void* piece_key, const void* piece_start,
                const void* slot, int n_pieces, void* partial, void* out, int add, int warp,
                void* stream) {
  ZArgs a = *(const ZArgs*)args;
  if (n_pieces <= 0) return 0;
  a.vec = a.vec && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_kpl(a.k, [&](auto kpl) {
    constexpr int KPL = decltype(kpl)::value;
    if (warp)
      zmap_logits_warp_kernel<KPL><<<blocks_for(n_pieces), THREADS, 0, s>>>(
          a, target, (const int*)piece_key, (const int*)piece_start, (const int*)slot,
          n_pieces, (double*)partial, (float*)out, add);
    else
      zmap_logits_kernel<KPL><<<seg_blocks(n_pieces, a.k), 32 * FLAT_WARPS, 0, s>>>(
          a, target, (const int*)piece_key, (const int*)piece_start, (const int*)slot,
          n_pieces, (double*)partial, (float*)out, add);
  });
}

int zmap_stats(const void* args, int target, const void* r, const void* piece_start,
               int n_pieces, void* partial, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_pieces <= 0) return 0;
  const int vec = a.k % 4 == 0 && aligned16(r) && aligned16(partial);
  return dispatch_kpl(a.k, [&](auto kpl) {
    zmap_stats_kernel<decltype(kpl)::value>
        <<<seg_blocks(n_pieces, a.k), 32 * FLAT_WARPS, 0, (cudaStream_t)stream>>>(
            a, target, (const float*)r, (const int*)piece_start, n_pieces, (float*)partial,
            vec);
  });
}

int zmap_strided(const void* args, int target, const void* r, const void* key_start,
                 int n_keys, void* out, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_keys <= 0) return 0;
  return dispatch_kpl(a.k, [&](auto kpl) {
    zmap_strided_kernel<decltype(kpl)::value>
        <<<blocks_for(n_keys), THREADS, 0, (cudaStream_t)stream>>>(
            a, target, (const float*)r, (const int*)key_start, n_keys, (float*)out);
  });
}

int zmap_runs(const void* args, int target, const void* r, const void* key_start, int n_runs,
              void* out, void* stream) {
  const ZArgs a = *(const ZArgs*)args;
  if (n_runs <= 0) return 0;
  const int vec = a.k % 4 == 0 && aligned16(r);
  return dispatch_kpl(a.k, [&](auto kpl) {
    zmap_runs_kernel<decltype(kpl)::value>
        <<<seg_blocks(n_runs, a.k), 32 * FLAT_WARPS, 0, (cudaStream_t)stream>>>(
            a, target, (const float*)r, (const int*)key_start, n_runs, (float*)out, vec);
  });
}

int zstats_sum(const void* x, int n, void* out, void* stream) {
  sum_kernel<<<1, SUM_THREADS, 0, (cudaStream_t)stream>>>((const float*)x, n, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
