// Standing-subscription matching for Hopper (sm_90a): every arriving object
// against every slot of the compiled subscription block. One kernel body in
// two instances:
//   wisk_sub_match       -- the (N, S) int8 match matrix on the packed
//                           operands (ops.sub_match, ops.match_subscriptions);
//   wisk_sub_match_pairs -- the matching (object, slot) pairs alone, from the
//                           objects' full-width bitmaps
//                           (ops.match_subscription_pairs: the stream's).
//
// Replaces the TPU kernel src/repro/kernels/sub_match.py::sub_match (row 11
// of the port's kernel table). Oracles: kernels/ref.py sub_match_packed_ref
// (the matrix instance), sub_match_pairs_ref (the pairs instance) and
// sub_match_ref (full-width bitmaps).
//
// A pair matches when the object's point lies in the subscription's closed
// rectangle, the two one-word OR-fold signatures share a bit, and one of the
// object's nonzero words ANDs non-zero with the subscription's word of the
// same id. Only compares and integer ANDs, so both outputs are
// bit-identical to the reference. Block padding is inert without a validity
// plane: an empty slot carries NEVER_RECT (contains no point) and signature 0.
//
// What bounds it on the H100: the point-in-rectangle compares, once the
// (N, S) matrix is no longer written (131,072,000 B at N = 1000, S =
// 131,072: 98 % of the matrix instance's bytes). The pairs instance writes
// 8 B per match (about 13,400 of 131 M pairs on the smoke's stream), and
// reads the block's rectangles and signatures once per object tile and the
// subscription words only for pairs that pass both tests. The design:
//   - objects are the staged side: a block takes a tile of `objs` objects
//     and a strip of 256 * kPasses slots, each thread walking kPasses = 8
//     slots (coalesced rectangle and signature loads). An object's words
//     are compacted once per strip, not once per 256 slots;
//   - the block sorts its tile by x in shared memory (a NaN x ranks as
//     +inf, so the order is total; such a point is inside no rectangle),
//     and a slot finds the first object at or right of its rectangle's
//     left edge by a binary search, then tests only the objects up to its
//     right edge: a point outside that span cannot be inside the
//     rectangle, so the N*S compares shrink to the pairs whose x already
//     fits (the lanes of a warp walk their spans together, as long as the
//     longest);
//   - the pairs instance stages an object from its full-width row: one
//     warp compacts its nonzero words into at most kObjPairs (word id,
//     value) pairs and folds its signature (wisk::warp_compact_words), so
//     the host packs nothing; the rare object with more nonzero words
//     reads the rest of its row where a pair needs it
//     (wisk::words_hit_from). The matrix instance stages its packed words;
//   - the pairs instance places a warp's hits by a ballot and a popc
//     prefix in the warp's slice of shared memory; at the end each block
//     adds its count to one global counter with one atomicAdd and copies
//     its pairs there (a warp whose slice fills first adds its own count
//     and copies). Pairs past `capacity` are counted and not written, so
//     the wrapper reads one count back and launches again at the exact
//     count if it passed the capacity: nothing is truncated. The pairs come
//     out in no fixed order; the caller sorts them.
//
// This is the simple version that is right first: no TMA, no tensor cores.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kObjPairs = 32;   // pairs instance: an object's words staged as pairs
constexpr int kWarpBuf = 128;   // pairs instance: hits a warp holds before it copies them
constexpr int kPasses = 8;      // slots per thread: 8 and 16 took the same time

struct Match {
  const float2* o_pts;     // (N, 2) object points
  const int32_t* o_bm;     // (N, W) object bitmaps (pairs instance)
  const int32_t* o_wids;   // (N, P) packed word ids (matrix instance)
  const int32_t* o_bits;   // (N, P) packed word values (matrix instance)
  const int32_t* o_sig;    // (N,) OR-fold object signatures (matrix instance)
  const float4* s_rects;   // (S, 4) (xlo, ylo, xhi, yhi)
  const int32_t* s_bm;     // (S, W)
  const int32_t* s_sig;    // (S,)
  int8_t* out;             // (N, S) (matrix instance)
  int2* pairs;             // (capacity,) (object index, slot) (pairs instance)
  int* count;              // (1,) matches found, zeroed by the wrapper (pairs instance)
  int N, S, W, P, objs, capacity;
};

// The key the tile is sorted by: x, with a NaN ranked as +inf so that every
// pair of objects compares (a NaN point matches no rectangle either way).
__device__ __forceinline__ float sort_x(float x) { return isnan(x) ? INFINITY : x; }

// Copy a warp's n buffered hits to the global pairs after reserving room
// with one atomicAdd; every lane calls it.
__device__ void flush_warp(int2* pairs, int* count, int capacity, const int2* buf, int n,
                           int lane) {
  __syncwarp();  // the hits are written before any lane copies them
  int base = 0;
  if (lane == 0) base = atomicAdd(count, n);
  base = __shfl_sync(0xffffffffu, base, 0);
  for (int i = lane; i < n; i += 32) {
    if (base + i < capacity) pairs[base + i] = buf[i];
  }
  __syncwarp();  // copied before the warp writes over its slice
}

template <bool kPairs>
__global__ void __launch_bounds__(kThreads) sub_match_kernel(Match A) {
  // the staged objects, each under its index j in the tile: the word id its
  // staged pairs stop at (resume; W when they hold them all), its signature
  // and pair count, its P word ids and P values; and the tile sorted by x:
  // headers (x, y, signature bits, pair count bits) and each one's j. Then
  // (pairs instance) the warps' hit slices.
  extern __shared__ float4 s_mem[];
  float4* s_hdr = s_mem;
  int2* s_buf = reinterpret_cast<int2*>(s_hdr + A.objs);
  int2* s_sn = s_buf + (kPairs ? kWarps * kWarpBuf : 0);
  int32_t* s_orig = reinterpret_cast<int32_t*>(s_sn + A.objs);
  int32_t* s_resume = s_orig + A.objs;
  int32_t* s_wid = s_resume + A.objs;
  int32_t* s_bit = s_wid + A.objs * A.P;
  __shared__ int s_cnt[kWarps];
  __shared__ int s_base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n0 = (int64_t)blockIdx.y * A.objs;
  const int n_obj = (int)min((int64_t)A.objs, (int64_t)A.N - n0);
  if constexpr (kPairs) {
    for (int j = warp; j < n_obj; j += kWarps) {  // warp-uniform
      int32_t fold;
      int resume;
      const int cnt = wisk::warp_compact_words(s_wid + j * A.P, s_bit + j * A.P,
                                               A.o_bm + (n0 + j) * A.W, 0, A.W, A.P, &fold,
                                               &resume);
      if (lane == 0) {
        s_sn[j] = make_int2(fold, min(cnt, A.P));
        s_resume[j] = resume;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_obj * A.P; i += kThreads) {
      const int64_t at = n0 * A.P + i;
      // clamp: a malformed id never reads out of the row
      s_wid[i] = min(max(__ldg(A.o_wids + at), 0), A.W - 1);
      s_bit[i] = __ldg(A.o_bits + at);
    }
    for (int j = threadIdx.x; j < n_obj; j += kThreads) {
      s_sn[j] = make_int2(__ldg(A.o_sig + n0 + j), A.P);
      s_resume[j] = A.W;
    }
  }
  __syncthreads();
  // sort the tile by x: object j goes to its rank by (sort_x(x), j), a
  // distinct rank each
  for (int j = threadIdx.x; j < n_obj; j += kThreads) {
    const float2 p = __ldg(A.o_pts + n0 + j);
    const float px = sort_x(p.x);
    int rank = 0;
#pragma unroll 8
    for (int u = 0; u < n_obj; ++u) {
      const float x = sort_x(__ldg(&A.o_pts[n0 + u].x));
      rank += (x < px) || (x == px && u < j);
    }
    const int2 sn = s_sn[j];
    s_hdr[rank] = make_float4(p.x, p.y, __int_as_float(sn.x), __int_as_float(sn.y));
    s_orig[rank] = j;
  }
  __syncthreads();

  int2* buf = s_buf + warp * kWarpBuf;
  int held = 0;  // hits in the warp's slice (warp-uniform)
  const unsigned below = (1u << lane) - 1u;
  int top = 1;  // the search's first step: the least power of two >= n_obj
  while (top < n_obj) top <<= 1;
  const int64_t strip = (int64_t)blockIdx.x * kThreads * kPasses;
  for (int it = 0; it < kPasses; ++it) {
    const int64_t s = strip + (int64_t)it * kThreads + threadIdx.x;
    const bool valid = s < A.S;
    if (__all_sync(0xffffffffu, !valid)) break;  // warp-uniform: the rest is past S
    const float4 r = valid ? __ldg(A.s_rects + s) : make_float4(1.f, 1.f, 0.f, 0.f);
    const int32_t sig = valid ? __ldg(A.s_sig + s) : 0;  // 0: a slot past S matches nothing
    const int32_t* row = A.s_bm + s * A.W;
    if constexpr (!kPairs) {  // every flag of the slot, then the hits over them
      if (valid) {
        for (int j = 0; j < n_obj; ++j) A.out[(n0 + j) * A.S + s] = 0;
      }
    }
    // the first object (in x order) at or right of the rectangle's left edge
    int lo = 0;
    for (int step = top; step > 0; step >>= 1) {
      if (lo + step <= n_obj && s_hdr[lo + step - 1].x < r.x) lo += step;
    }
    // walk the objects whose x lies in the rectangle's span, a lane per slot
    bool more = valid;
    for (int k = lo; __any_sync(0xffffffffu, more); ++k) {  // warp-uniform trip count
      more = more && k < n_obj;
      const float4 h = more ? s_hdr[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      more = more && h.x <= r.z;
      bool hit = false;
      int j = 0;
      // h.x >= r.x holds past the search but for a NaN edge, which meets no point
      if (more && h.x >= r.x && h.y >= r.y && h.y <= r.w && (__float_as_int(h.z) & sig) != 0) {
        j = s_orig[k];
        hit = wisk::pairs_hit(row, s_wid + j * A.P, s_bit + j * A.P, __float_as_int(h.w)) ||
              (s_resume[j] < A.W &&
               wisk::words_hit_from(row, A.o_bm + (n0 + j) * A.W, s_resume[j], A.W));
      }
      if constexpr (kPairs) {
        const unsigned b = __ballot_sync(0xffffffffu, hit);
        if (b != 0) {  // warp-uniform
          if (held + __popc(b) > kWarpBuf) {
            flush_warp(A.pairs, A.count, A.capacity, buf, held, lane);
            held = 0;
          }
          if (hit) buf[held + __popc(b & below)] = make_int2((int)(n0 + j), (int)s);
          held += __popc(b);
        }
      } else if (hit) {
        A.out[(n0 + j) * A.S + s] = 1;
      }
    }
  }
  if constexpr (kPairs) {
    __syncwarp();
    if (lane == 0) s_cnt[warp] = held;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
      s_base = total > 0 ? atomicAdd(A.count, total) : 0;
    }
    __syncthreads();
    int off = s_base;
    for (int w = 0; w < warp; ++w) off += s_cnt[w];
    for (int i = lane; i < held; i += 32) {
      if (off + i < A.capacity) A.pairs[off + i] = buf[i];
    }
  }
}

template <bool kPairs>
int launch(Match A, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (A.objs < 1 || A.P < 0) return (int)cudaErrorInvalidValue;
  if (A.N > 0 && A.S > 0) {
    const int64_t strip = (int64_t)kThreads * kPasses;
    const dim3 grid((unsigned)((A.S + strip - 1) / strip), (unsigned)((A.N + A.objs - 1) / A.objs));
    const size_t smem = (size_t)A.objs * (sizeof(float4) + sizeof(int2))
        + (kPairs ? (size_t)kWarps * kWarpBuf * sizeof(int2) : 0)
        + (size_t)A.objs * (2 + 2 * (size_t)A.P) * sizeof(int32_t);
    sub_match_kernel<kPairs><<<grid, kThreads, smem, (cudaStream_t)stream>>>(A);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
// The wrapper picks `objs` (objects per block) so that the staged objects
// take at most 32 KiB of shared memory.

// The (N, S) int8 match matrix on packed object words (ids o_wids, values
// o_bits, Wp of each, from ops.pack_query_words) and signatures o_sig.
int wisk_sub_match(const void* o_pts, const void* o_wids, const void* o_bits,
                   const void* o_sig, const void* s_rects, const void* s_bm,
                   const void* s_sig, void* out, int N, int S, int Wp, int W, int objs,
                   int device, void* stream) {
  Match A = {};
  A.o_pts = (const float2*)o_pts;
  A.o_wids = (const int32_t*)o_wids;
  A.o_bits = (const int32_t*)o_bits;
  A.o_sig = (const int32_t*)o_sig;
  A.s_rects = (const float4*)s_rects;
  A.s_bm = (const int32_t*)s_bm;
  A.s_sig = (const int32_t*)s_sig;
  A.out = (int8_t*)out;
  A.N = N;
  A.S = S;
  A.W = W;
  A.P = Wp;
  A.objs = objs;
  return launch<false>(A, device, stream);
}

// The matching (object index, slot) pairs, from the objects' full-width
// (N, W) bitmaps o_bm: the first min(*count, capacity) entries of `pairs`
// (int32 x 2 each) in no fixed order, and *count (zeroed by the caller)
// the number of matches.
int wisk_sub_match_pairs(const void* o_pts, const void* o_bm, const void* s_rects,
                         const void* s_bm, const void* s_sig, void* pairs, void* count,
                         int N, int S, int W, int objs, int capacity, int device,
                         void* stream) {
  Match A = {};
  A.o_pts = (const float2*)o_pts;
  A.o_bm = (const int32_t*)o_bm;
  A.s_rects = (const float4*)s_rects;
  A.s_bm = (const int32_t*)s_bm;
  A.s_sig = (const int32_t*)s_sig;
  A.pairs = (int2*)pairs;
  A.count = (int*)count;
  A.N = N;
  A.S = S;
  A.W = W;
  A.P = min(W, kObjPairs);
  A.objs = objs;
  A.capacity = capacity;
  return launch<true>(A, device, stream);
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
