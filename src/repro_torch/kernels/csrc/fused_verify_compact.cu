// Fused leaf gather + verify on the compact leaf bank, for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 2 and 3 of the port's kernel table):
//   src/repro/kernels/fused_verify.py::fused_verify_compact           -> the
//     query-tile launch below (variant="vmem"): one block per tile of BM
//     queries, a warp per (query, slot) pair of the tile;
//   src/repro/kernels/fused_verify.py::fused_verify_prefetch_compact  -> the
//     (M, T) launch below (variant="prefetch", and "auto"): one block per
//     (query, slot), its threads striding over the leaf row's objects.
// Oracles: kernels/ref.py fused_verify_leaf_words_ref (remap_query_words_ref,
// then fused_verify_compact_ref) and fused_verify_compact_ref in this
// package. The full-width twins are in fused_verify.cu.
//
// Each launch is one template body in two instances (kRemap), which differ
// only in where the pair's query words come from:
//   - remapping (ops.fused_verify_leaf_words, the engine's entry): the
//     kernel takes the query's global bitmap q_bm (M, W) and the leaf
//     dictionaries leaf_terms (K, 32*Wl; the global term of each leaf-local
//     bit, -1 pad) and remaps the query's bits into the pair's leaf
//     vocabulary itself -- what remap_query_words built before the launch
//     in about 20 tensor ops over (M, T, 32*Wl) temporaries. Local bit l of
//     the pair's leaf is
//       term = leaf_terms[leaf, l]
//       term >= 0 ? bit min(term, 32*W-1) of q_bm[m] : 0
//     (the reference's clip and its inert -1 pad). Bit l sits at bit l & 31
//     of word l >> 5, so a warp builds word w with one ballot: lane i loads
//     entry 32*w + i (a coalesced 128-byte row) and the one query word that
//     entry names, and __ballot_sync gives the word with lane i's bit at
//     bit i. q_sig is the OR of the Wl words. When asked (out_cbm / out_sig
//     not null) the kernel also writes the words out, for the insert-slot
//     verify of a delta that carries compact insert bitmaps;
//   - given words (ops.fused_gather_verify_compact, the TPU kernels'
//     operands): q_cbm[m, t] and q_sig[m, t] as the caller remapped them.
// Either way the Wl words go to shared memory and the same per-object
// predicate follows: object o of leaf clamp(top_leaf[m, t], 0, K-1) (the
// clamp of fused_verify.py:243 and :364),
//   kw    = (obj_sig & q_sig) != 0 AND any(obj_cbm[w] & q_cbm[m, t, w]),
//   valid = obj_id >= 0 AND leaf_ok[m, t] > 0,
//   inr   = the point lies in the closed query rectangle,
// and ids[m, t*OBJ + o] = obj_id if inr & kw & valid else -1. The per-slot
// count kwv[m, t] sums kw & valid -- keyword hits outside the rectangle
// included: it is the Eq. 1 ``verified`` count, not the number of matches.
// The signature test is a prefilter: the word loop runs only when it
// passes, which cannot change kw (an overlapping word always sets a shared
// signature bit).
//
// Exact early exit: a pair whose leaf_ok is 0, or whose q_sig is 0 (the
// reference's kill flag: none of the query's terms is in the leaf's
// dictionary), cannot match and counts nothing. It writes OBJ x -1 and
// kwv = 0 and reads no object row; with leaf_ok = 0 and no words asked for
// it does not remap either.
//
// What bounds it on the H100: bytes, not arithmetic -- the ids written out
// (M x T*OBJ int32) and the leaf rows of the pairs whose signature passes:
// the ids of the selected rows, the signatures of live objects, the compact
// words of signature-passing objects and the coordinates of keyword hits;
// for the remap a dictionary row per live pair and the query words it
// names. The work per byte is a few compares and ANDs. The (M, T) launch
// gives each pair its own block so many rows are in flight. The query-tile
// launch stages its BM queries' bitmaps in shared memory with coalesced
// loads (where they fit), walks its pairs a warp each -- lanes over the
// objects, a warp sum into kwv: no shared atomics and no 64-bit division
// per object -- and the wrapper keeps BM small, so a batch of 1024 queries
// gives several blocks per SM.
//
// This is the simple version that is right first: no vector loads, no TMA.
// The outputs are bit-identical to the reference: only floats are compared,
// counts are integer sums, and the remap only moves bits.
#include "slot_predicates.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kRemapGroup = 4;  // words whose loads a warp issues before it votes

struct Bank {
  const float* q_rects;       // (M, 4)
  const int32_t* q_cbm;       // given words: (M, T, Wl)
  const int32_t* q_sig;       // given words: (M, T)
  const int32_t* q_bm;        // remapping: (M, W)
  const int32_t* leaf_terms;  // remapping: (K, 32 * Wl)
  const int32_t* top_leaf;    // (M, T)
  const int8_t* leaf_ok;      // (M, T)
  const float* obj_x;         // (K, OBJ)
  const float* obj_y;         // (K, OBJ)
  const int32_t* obj_cbm;     // (K, OBJ, Wl)
  const int32_t* obj_sig;     // (K, OBJ)
  const int32_t* obj_id;      // (K, OBJ)
  int32_t* ids;               // (M, T * OBJ)
  int32_t* kwv;               // (M, T)
  int32_t* out_cbm;           // remapping, null unless asked: (M, T, Wl)
  int32_t* out_sig;           // remapping, null unless asked: (M, T)
  int M, T, K, OBJ, Wl, W;
};

// The leaf a pair reads: dirty ids clamp like the reference.
__device__ __forceinline__ int pair_leaf(const Bank& b, int64_t pair) {
  return min(max(__ldg(b.top_leaf + pair), 0), b.K - 1);
}

// Remap the query words w0, w0 + stride, ... (< Wl) of a pair with leaf
// `leaf` into s_words, by one warp (every lane calls it, so each ballot has
// the whole warp); returns the OR of the words it built, the same on every
// lane. `q` is the query's bitmap row: read through the read-only path
// (kLdg) or, staged in shared memory, by a plain load. The loads of
// kRemapGroup words are issued before their ballots, a round trip per group
// rather than per word.
template <bool kLdg>
__device__ __forceinline__ int32_t remap_words(const Bank& b, const int32_t* q, int leaf, int w0,
                                               int stride, int32_t* s_words, int lane) {
  const int32_t* lt = b.leaf_terms + (int64_t)leaf * 32 * b.Wl + lane;
  const int top = 32 * b.W - 1;
  int32_t sig = 0;
  for (int w = w0; w < b.Wl; w += kRemapGroup * stride) {  // warp-uniform trip count
    int32_t term[kRemapGroup];
#pragma unroll
    for (int j = 0; j < kRemapGroup; ++j) {
      const int wj = w + j * stride;
      term[j] = wj < b.Wl ? __ldg(lt + 32 * wj) : -1;
    }
    bool bit[kRemapGroup];
#pragma unroll
    for (int j = 0; j < kRemapGroup; ++j) {
      bit[j] = false;
      if (term[j] >= 0) {
        const int pos = min(term[j], top);
        const uint32_t word = kLdg ? (uint32_t)__ldg(q + (pos >> 5)) : (uint32_t)q[pos >> 5];
        bit[j] = ((word >> (pos & 31)) & 1u) != 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kRemapGroup; ++j) {
      const int wj = w + j * stride;
      const int32_t word = (int32_t)__ballot_sync(0xffffffffu, bit[j]);
      if (wj < b.Wl) {
        if (lane == 0) s_words[wj] = word;
        sig |= word;
      }
    }
  }
  return sig;
}

// Object o of a live pair (leaf_ok > 0; the others exit before) against the
// pair's words s_q (Wl words in shared memory) and signature qsig: writes
// its id slot and returns 1 when it counts toward kwv (kw & valid).
__device__ __forceinline__ int verify_object(const Bank& b, const float* rect, int64_t row,
                                             int64_t out, int32_t qsig, const int32_t* s_q,
                                             int o) {
  const int64_t obj = row + o;
  const int32_t cid = __ldg(b.obj_id + obj);
  bool kw = false;
  if (cid >= 0 && (__ldg(b.obj_sig + obj) & qsig) != 0) {
    const int32_t* cb = b.obj_cbm + obj * b.Wl;
    for (int w = 0; w < b.Wl; ++w) {
      if ((__ldg(cb + w) & s_q[w]) != 0) {
        kw = true;
        break;
      }
    }
  }
  const bool inr = kw && wisk::point_in_rect(rect, __ldg(b.obj_x + obj), __ldg(b.obj_y + obj));
  b.ids[out + o] = inr ? cid : -1;
  return kw ? 1 : 0;
}

// Whether a pair builds its words: a live pair always; a dead one only for
// the remapping instance's word output.
template <bool kRemap>
__device__ __forceinline__ bool needs_words(const Bank& b, bool ok) {
  return ok || (kRemap && b.out_cbm != nullptr);
}

// variant="prefetch"/"auto": one block per (query, slot). Warp j remaps
// words j, j + n_warps, ... (or the block copies the given words); the
// block reduces kwv.
template <bool kRemap>
__global__ void fused_verify_slot_kernel(Bank b) {
  extern __shared__ int32_t s_q[];  // the pair's Wl query words
  __shared__ int32_t s_part[32];    // per-warp signature parts, then per-warp counts
  const int64_t pair = blockIdx.x;
  const int64_t m = pair / b.T;
  const int leaf = pair_leaf(b, pair);
  const bool ok = __ldg(b.leaf_ok + pair) > 0;
  const int64_t out = pair * b.OBJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int32_t qsig = 0;
  if (needs_words<kRemap>(b, ok)) {  // block-uniform
    if constexpr (kRemap) {
      const int32_t part = remap_words<true>(b, b.q_bm + m * b.W, leaf, warp, n_warps, s_q, lane);
      if (lane == 0) s_part[warp] = part;
    } else {
      for (int w = threadIdx.x; w < b.Wl; w += blockDim.x) s_q[w] = __ldg(b.q_cbm + pair * b.Wl + w);
    }
    __syncthreads();
    if constexpr (kRemap) {
      for (int w = 0; w < n_warps; ++w) qsig |= s_part[w];
      if (b.out_cbm != nullptr) {
        for (int w = threadIdx.x; w < b.Wl; w += blockDim.x) b.out_cbm[pair * b.Wl + w] = s_q[w];
        if (threadIdx.x == 0) b.out_sig[pair] = qsig;
      }
      __syncthreads();  // every thread has read s_part before the counts reuse it
    } else {
      qsig = __ldg(b.q_sig + pair);
    }
  }
  if (!ok || qsig == 0) {  // nothing in the pair can match or count
    for (int o = threadIdx.x; o < b.OBJ; o += blockDim.x) b.ids[out + o] = -1;
    if (threadIdx.x == 0) b.kwv[pair] = 0;
    return;
  }
  const float* rect = b.q_rects + m * 4;
  const int64_t row = (int64_t)leaf * b.OBJ;
  int local = 0;
  for (int o = threadIdx.x; o < b.OBJ; o += blockDim.x) {
    local += verify_object(b, rect, row, out, qsig, s_q, o);
  }
  local = __reduce_add_sync(0xffffffffu, local);
  if (lane == 0) s_part[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < n_warps; ++w) sum += s_part[w];
    b.kwv[pair] = sum;
  }
}

// variant="vmem": one block per tile of BM queries, a warp per (query,
// slot) pair of the tile. Shared memory: each warp's Wl words, then (the
// remapping instance, `stage`) the tile's BM query rows of W words.
template <bool kRemap>
__global__ void fused_verify_tile_kernel(Bank b, int BM, int stage) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* s_q = smem + warp * b.Wl;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int rows = (int)min((int64_t)BM, (int64_t)b.M - m0);
  const int32_t* q_rows = nullptr;
  if constexpr (kRemap) {
    q_rows = b.q_bm + m0 * b.W;
    if (stage) {
      int32_t* s_rows = smem + kTileWarps * b.Wl;
      const int n = rows * b.W;
      for (int i = threadIdx.x; i < n; i += blockDim.x) s_rows[i] = __ldg(q_rows + i);
      q_rows = s_rows;
      __syncthreads();
    }
  }
  const int pairs = rows * b.T;
  for (int p = warp; p < pairs; p += kTileWarps) {  // warp-uniform
    __syncwarp();  // the previous pair's words are read before they are rewritten
    const int r = p / b.T;
    const int64_t m = m0 + r;
    const int64_t pair = m * b.T + (p - r * b.T);
    const int leaf = pair_leaf(b, pair);
    const bool ok = __ldg(b.leaf_ok + pair) > 0;
    const int64_t out = pair * b.OBJ;
    int32_t qsig = 0;
    if (needs_words<kRemap>(b, ok)) {
      if constexpr (kRemap) {
        qsig = remap_words<false>(b, q_rows + (int64_t)r * b.W, leaf, 0, 1, s_q, lane);
      } else {
        for (int w = lane; w < b.Wl; w += 32) s_q[w] = __ldg(b.q_cbm + pair * b.Wl + w);
        qsig = __ldg(b.q_sig + pair);
      }
      __syncwarp();
      if (kRemap && b.out_cbm != nullptr) {
        for (int w = lane; w < b.Wl; w += 32) b.out_cbm[pair * b.Wl + w] = s_q[w];
        if (lane == 0) b.out_sig[pair] = qsig;
      }
    }
    if (!ok || qsig == 0) {  // nothing in the pair can match or count
      for (int o = lane; o < b.OBJ; o += 32) b.ids[out + o] = -1;
      if (lane == 0) b.kwv[pair] = 0;
      continue;
    }
    const float* rect = b.q_rects + m * 4;
    const int64_t row = (int64_t)leaf * b.OBJ;
    int local = 0;
    for (int o = lane; o < b.OBJ; o += 32) {
      local += verify_object(b, rect, row, out, qsig, s_q, o);
    }
    local = __reduce_add_sync(0xffffffffu, local);
    if (lane == 0) b.kwv[pair] = local;
  }
}

Bank make_bank(const void* q_rects, const void* top_leaf, const void* leaf_ok,
               const void* obj_x, const void* obj_y, const void* obj_cbm, const void* obj_sig,
               const void* obj_id, void* ids, void* kwv, int M, int T, int K, int OBJ, int Wl) {
  Bank b = {};
  b.q_rects = (const float*)q_rects;
  b.top_leaf = (const int32_t*)top_leaf;
  b.leaf_ok = (const int8_t*)leaf_ok;
  b.obj_x = (const float*)obj_x;
  b.obj_y = (const float*)obj_y;
  b.obj_cbm = (const int32_t*)obj_cbm;
  b.obj_sig = (const int32_t*)obj_sig;
  b.obj_id = (const int32_t*)obj_id;
  b.ids = (int32_t*)ids;
  b.kwv = (int32_t*)kwv;
  b.M = M;
  b.T = T;
  b.K = K;
  b.OBJ = OBJ;
  b.Wl = Wl;
  return b;
}

Bank given_bank(const void* q_rects, const void* q_cbm, const void* q_sig, const void* top_leaf,
                const void* leaf_ok, const void* obj_x, const void* obj_y, const void* obj_cbm,
                const void* obj_sig, const void* obj_id, void* ids, void* kwv, int M, int T,
                int K, int OBJ, int Wl) {
  Bank b = make_bank(q_rects, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm, obj_sig, obj_id, ids, kwv,
                     M, T, K, OBJ, Wl);
  b.q_cbm = (const int32_t*)q_cbm;
  b.q_sig = (const int32_t*)q_sig;
  return b;
}

Bank remap_bank(const void* q_rects, const void* q_bm, const void* leaf_terms,
                const void* top_leaf, const void* leaf_ok, const void* obj_x, const void* obj_y,
                const void* obj_cbm, const void* obj_sig, const void* obj_id, void* ids,
                void* kwv, void* out_cbm, void* out_sig, int M, int T, int K, int OBJ, int Wl,
                int W) {
  Bank b = make_bank(q_rects, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm, obj_sig, obj_id, ids, kwv,
                     M, T, K, OBJ, Wl);
  b.q_bm = (const int32_t*)q_bm;
  b.leaf_terms = (const int32_t*)leaf_terms;
  b.out_cbm = (int32_t*)out_cbm;
  b.out_sig = (int32_t*)out_sig;
  b.W = W;
  return b;
}

template <bool kRemap>
int launch_tile(const Bank& b, int BM, int stage, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b.M > 0 && b.T > 0) {
    const unsigned blocks = (unsigned)((b.M + BM - 1) / BM);
    const size_t smem =
        ((size_t)kTileWarps * b.Wl + (stage ? (size_t)BM * b.W : 0)) * sizeof(int32_t);
    fused_verify_tile_kernel<kRemap>
        <<<blocks, kTileThreads, smem, (cudaStream_t)stream>>>(b, BM, stage);
  }
  return (int)cudaGetLastError();
}

template <bool kRemap>
int launch_slot(const Bank& b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b.M > 0 && b.T > 0) {
    int threads = ((b.OBJ + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
    const unsigned blocks = (unsigned)((int64_t)b.M * b.T);
    const size_t smem = (size_t)b.Wl * sizeof(int32_t);
    fused_verify_slot_kernel<kRemap><<<blocks, threads, smem, (cudaStream_t)stream>>>(b);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_fused_verify_compact_tile(
    const void* q_rects, const void* q_cbm, const void* q_sig, const void* top_leaf,
    const void* leaf_ok, const void* obj_x, const void* obj_y, const void* obj_cbm,
    const void* obj_sig, const void* obj_id, void* ids, void* kwv, int M, int T, int K, int OBJ,
    int Wl, int BM, int device, void* stream) {
  return launch_tile<false>(given_bank(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y,
                                       obj_cbm, obj_sig, obj_id, ids, kwv, M, T, K, OBJ, Wl),
                            BM, 0, device, stream);
}

int wisk_fused_verify_compact_slot(
    const void* q_rects, const void* q_cbm, const void* q_sig, const void* top_leaf,
    const void* leaf_ok, const void* obj_x, const void* obj_y, const void* obj_cbm,
    const void* obj_sig, const void* obj_id, void* ids, void* kwv, int M, int T, int K, int OBJ,
    int Wl, int device, void* stream) {
  return launch_slot<false>(given_bank(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y,
                                       obj_cbm, obj_sig, obj_id, ids, kwv, M, T, K, OBJ, Wl),
                            device, stream);
}

int wisk_fused_verify_remap_tile(
    const void* q_rects, const void* q_bm, const void* leaf_terms, const void* top_leaf,
    const void* leaf_ok, const void* obj_x, const void* obj_y, const void* obj_cbm,
    const void* obj_sig, const void* obj_id, void* ids, void* kwv, void* out_cbm, void* out_sig,
    int M, int T, int K, int OBJ, int Wl, int W, int BM, int stage, int device, void* stream) {
  return launch_tile<true>(remap_bank(q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, obj_x, obj_y,
                                      obj_cbm, obj_sig, obj_id, ids, kwv, out_cbm, out_sig, M, T,
                                      K, OBJ, Wl, W),
                           BM, stage, device, stream);
}

int wisk_fused_verify_remap_slot(
    const void* q_rects, const void* q_bm, const void* leaf_terms, const void* top_leaf,
    const void* leaf_ok, const void* obj_x, const void* obj_y, const void* obj_cbm,
    const void* obj_sig, const void* obj_id, void* ids, void* kwv, void* out_cbm, void* out_sig,
    int M, int T, int K, int OBJ, int Wl, int W, int device, void* stream) {
  return launch_slot<true>(remap_bank(q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, obj_x, obj_y,
                                      obj_cbm, obj_sig, obj_id, ids, kwv, out_cbm, out_sig, M, T,
                                      K, OBJ, Wl, W),
                           device, stream);
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
