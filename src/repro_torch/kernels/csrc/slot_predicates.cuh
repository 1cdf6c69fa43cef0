// Predicates shared by the port's kernels: the frontier filters
// (frontier.cu), the kNN distance filters (knn_filter.cu), the verify
// kernels (skr_verify.cu, fused_verify.cu, fused_verify_compact.cu), the
// dense filter (skr_filter.cu) and the subscription match (sub_match.cu);
// the block-wide compaction of a query's nonzero words that the frontier
// filters and the (M, T) full-width verify share, and the warp-wide one of
// the dense filter and the subscription match.
//
// Every function is a plain __device__ inline: the kernels that include this
// header differ only in how threads map onto slots or candidates (one thread
// each on the compact planes and where a full-width row is read at the
// query's packed or compacted words, one warp each where it is read whole)
// and in what they write (an int8 flag, an object id or an f32 squared
// distance).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wisk {

// The slot's MBR from its four int16 rank codes, dequantized through the
// level's sorted f32 coordinate dictionaries (exact: each code indexes the
// value it was built from). The dictionaries (up to 32767 f32 each, so the
// two together can pass the 227 KB of shared memory) are read through the
// read-only path; they are small and hot, so L1/L2 keep them. Codes come
// from the snapshot's encoder and are always in range: the clamp only keeps
// a malformed code from reading out of bounds.
__device__ __forceinline__ float4 dequantize_mbr(const int16_t* __restrict__ c,
                                                 const float* __restrict__ dict_x,
                                                 const float* __restrict__ dict_y,
                                                 int Dx, int Dy) {
  const int cx0 = min(max((int)__ldg(c + 0), 0), Dx - 1);
  const int cy0 = min(max((int)__ldg(c + 1), 0), Dy - 1);
  const int cx1 = min(max((int)__ldg(c + 2), 0), Dx - 1);
  const int cy1 = min(max((int)__ldg(c + 3), 0), Dy - 1);
  return make_float4(__ldg(dict_x + cx0), __ldg(dict_y + cy0), __ldg(dict_x + cx1),
                     __ldg(dict_y + cy1));
}

// The f32 MBR (xlo, ylo, xhi, yhi) of a slot on the full-width planes.
__device__ __forceinline__ float4 load_mbr(const float* __restrict__ m) {
  return make_float4(__ldg(m + 0), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3));
}

// Closed-rectangle intersection of query rect q = (xlo, ylo, xhi, yhi) and
// an MBR: only compares, so bit-identical to the reference by construction.
__device__ __forceinline__ bool rect_meets(const float* __restrict__ q, float4 b) {
  return (__ldg(q + 0) <= b.z) && (b.x <= __ldg(q + 2)) && (__ldg(q + 1) <= b.w) &&
         (b.y <= __ldg(q + 3));
}

// The same test with the query rectangle already in registers.
__device__ __forceinline__ bool rect_meets(float4 q, float4 b) {
  return (q.x <= b.z) && (b.x <= q.z) && (q.y <= b.w) && (b.y <= q.w);
}

// A point inside the closed query rectangle q = (xlo, ylo, xhi, yhi): the
// verify stages' test, compares only.
__device__ __forceinline__ bool point_in_rect(const float* __restrict__ q, float x, float y) {
  return x >= __ldg(q + 0) && x <= __ldg(q + 2) && y >= __ldg(q + 1) && y <= __ldg(q + 3);
}

// max(a, b) that returns NaN when either operand is NaN, as jnp.maximum and
// torch.maximum do (fmaxf returns the other operand). On other operands it
// equals fmaxf.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Squared min-distance from point (px, py) to a closed MBR. Each product and
// the sum round to nearest on their own (__fmul_rn / __fadd_rn are never
// contracted into a fused multiply-add, which nvcc does by default), so the
// result equals the plain PyTorch version and the host oracle bit for bit; a
// NaN coordinate gives NaN, as there.
__device__ __forceinline__ float mbr_dist2(float px, float py, float4 b) {
  const float dx = max_nan(max_nan(b.x - px, px - b.z), 0.f);
  const float dy = max_nan(max_nan(b.y - py, py - b.w), 0.f);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Keyword test by one thread: any of the n words ANDs non-zero with the
// query's. Stops at the first hit.
__device__ __forceinline__ bool words_hit_thread(const int32_t* __restrict__ fb,
                                                 const int32_t* __restrict__ qb, int n) {
  for (int p = 0; p < n; ++p) {
    if ((__ldg(fb + p) & __ldg(qb + p)) != 0) return true;
  }
  return false;
}

// Keyword test by a whole warp (all 32 lanes must call it) against the
// query's words `qb`, staged in shared memory (stage_words): lane l reads
// words l, l + 32, ..., so neighbouring lanes read neighbouring words of the
// row (coalesced 128-byte rows). Stops after the first 32-word stride that
// holds a hit. The result is the same on every lane.
__device__ __forceinline__ bool words_hit_warp(const int32_t* __restrict__ fb,
                                               const int32_t* qb, int n, int lane) {
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    const bool hit = p < n && (__ldg(fb + p) & qb[p]) != 0;
    if (__any_sync(0xffffffffu, hit)) return true;
  }
  return false;
}

// Copy a query's n words into shared memory, every thread of the block
// taking part; the caller synchronises before reading them.
__device__ __forceinline__ void stage_words(int32_t* s, const int32_t* __restrict__ g, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = __ldg(g + i);
}

// Copy n packed query words -- word ids `g_wids` and values `g_bits`, as
// ops.pack_query_words makes them -- into shared memory, every thread of
// the block taking part; the caller synchronises before reading them. The
// ids index a W-word row: packed ids are in range, and the clamp only keeps
// a malformed one from reading out of bounds.
__device__ __forceinline__ void stage_packed_words(int32_t* s_wid, int32_t* s_bit,
                                                   const int32_t* __restrict__ g_wids,
                                                   const int32_t* __restrict__ g_bits,
                                                   int n, int W) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_wid[i] = min(max(__ldg(g_wids + i), 0), W - 1);
    s_bit[i] = __ldg(g_bits + i);
  }
}

// Keyword test by one thread on a full-width row at n (word id, value)
// pairs in shared memory -- the query's nonzero words, compacted in the
// kernel, or its packed words, whose zero padding values are skipped: no
// other word can hit. A miss needs every pair, so the loads of a group of
// kGroup pairs are issued together (no branch between a load and the next)
// and tested once, a memory round trip per group rather than per word; a
// hit stops after its group. The ids index the row: compacted and packed
// ids are in range.
template <int kGroup = 8>
__device__ __forceinline__ bool pairs_hit(const int32_t* __restrict__ row,
                                          const int32_t* s_wid, const int32_t* s_bit, int n) {
  for (int p = 0; p < n; p += kGroup) {
    int32_t acc = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int32_t q = p + j < n ? s_bit[p + j] : 0;
      if (q != 0) acc |= __ldg(row + s_wid[p + j]) & q;
    }
    if (acc != 0) return true;
  }
  return false;
}

// Query words a block compacts per round (compact_words): at most 16 KB of
// (word id, value) pairs in shared memory, whatever W is.
constexpr int kRoundWords = 2048;

// Compact the n words q[w0 .. w0 + n) into (word id, value) pairs of the
// nonzero ones, in word order, at s_wid / s_bit; every thread of the block
// (a multiple of 32) takes part, and every thread gets the count. Each warp
// owns a slice of the words: a first pass counts its nonzero words with
// ballots, and after the counts are shared (``s_cnt``, one int per warp) a
// second pass writes its pairs after the pairs of the warps before it -- a
// prefix count, no atomics. The pairs feed pairs_hit.
__device__ inline int compact_words(int32_t* s_wid, int32_t* s_bit, int* s_cnt,
                                    const int32_t* __restrict__ q, int w0, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int span = (n + 32 * n_warps - 1) / (32 * n_warps) * 32;  // words per warp
  const int lo = min(warp * span, n);
  const int hi = min(lo + span, n);
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {  // warp-uniform trip count
    const int p = base + lane;
    cnt += __popc(__ballot_sync(0xffffffffu, p < hi && __ldg(q + w0 + p) != 0));
  }
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < n_warps; ++w) {
    off += w < warp ? s_cnt[w] : 0;
    total += s_cnt[w];
  }
  for (int base = lo; base < hi; base += 32) {
    const int p = base + lane;
    const int32_t v = p < hi ? __ldg(q + w0 + p) : 0;
    const unsigned nz = __ballot_sync(0xffffffffu, v != 0);
    if (v != 0) {
      const int at = off + __popc(nz & ((1u << lane) - 1u));
      s_wid[at] = w0 + p;
      s_bit[at] = v;
    }
    off += __popc(nz);
  }
  __syncthreads();
  return total;
}

// 32-word chunks a warp-wide compaction loads before it tests any of them:
// one memory round trip per kWarpLoads chunks rather than per chunk.
constexpr int kWarpLoads = 8;

// compact_words by one warp (all 32 lanes must call it, with the same
// arguments): the nonzero words of q[w0 .. w0 + n), in word order, as
// (word id, value) pairs at s_wid / s_bit, at most `cap` of them. Lane l
// reads words l, l + 32, ... (coalesced), kWarpLoads chunks per memory
// round trip, and a ballot and a popc prefix place each chunk's pairs. No
// block-wide step, so a block whose warps take different queries needs no
// vote before it compacts. Every lane gets back:
//   - the count of nonzero words (which may pass `cap`);
//   - in *fold, the OR of all n words (the query's one-word signature);
//   - in *resume, the id of the first nonzero word not stored (w0 + n
//     when all were).
// The caller syncs the warp (__syncwarp) before another compaction writes
// over pairs that lanes may still read.
__device__ inline int warp_compact_words(int32_t* s_wid, int32_t* s_bit,
                                         const int32_t* __restrict__ q, int w0, int n,
                                         int cap, int32_t* fold, int* resume) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  int32_t acc = 0;
  int first_left = w0 + n;
  for (int base = 0; base < n; base += 32 * kWarpLoads) {  // warp-uniform trip count
    int32_t v[kWarpLoads];
#pragma unroll
    for (int c = 0; c < kWarpLoads; ++c) {
      const int p = base + 32 * c + lane;
      v[c] = p < n ? __ldg(q + w0 + p) : 0;
    }
#pragma unroll
    for (int c = 0; c < kWarpLoads; ++c) {
      acc |= v[c];
      const unsigned nz = __ballot_sync(0xffffffffu, v[c] != 0);
      if (v[c] != 0) {
        const int at = cnt + __popc(nz & below);
        if (at < cap) {
          s_wid[at] = w0 + base + 32 * c + lane;
          s_bit[at] = v[c];
        } else if (at == cap) {
          first_left = w0 + base + 32 * c + lane;
        }
      }
      cnt += __popc(nz);
    }
  }
  *fold = (int32_t)__reduce_or_sync(0xffffffffu, (unsigned)acc);
  *resume = __reduce_min_sync(0xffffffffu, first_left);
  __syncwarp();  // the pairs are written before any lane reads them
  return cnt;
}

// Keyword test by one thread on a full-width row `row` against the words of
// a query's full-width row `q` from word w0 to n - 1: the tail a capped
// warp_compact_words left out. Reads each query word, and the row's word
// only where the query's is nonzero; stops at the first hit.
__device__ __forceinline__ bool words_hit_from(const int32_t* __restrict__ row,
                                               const int32_t* __restrict__ q, int w0, int n) {
  for (int w = w0; w < n; ++w) {
    const int32_t v = __ldg(q + w);
    if (v != 0 && (__ldg(row + w) & v) != 0) return true;
  }
  return false;
}

}  // namespace wisk
