// Fused leaf gather + verify on the full-width leaf bank, for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 5 and 6 of the port's kernel table):
//   src/repro/kernels/fused_verify.py::fused_verify          -> the query-tile
//     kernel below (variant="vmem"): one block per BM queries x TC selected
//     leaf slots, one thread per object;
//   src/repro/kernels/fused_verify.py::fused_verify_prefetch -> the (M, T)
//     kernel below (variant="prefetch", and "auto"): one block per (query,
//     slot), one thread per object of the leaf row.
// They serve compact=False, a snapshot without a compact bank (a leaf
// dictionary above LEAF_DICT_MAX), and the base blocks of a live delta over
// such a snapshot. Oracles: kernels/ref.py fused_verify_ref, and
// fused_verify_packed_ref on the tile kernel's packed query words. The
// compact twins are in fused_verify_compact.cu.
//
// Both launches compute, per object of leaf clamp(top_leaf[m, t], 0, K-1)
// (the clamp of fused_verify.py:86 and :197),
//   valid = obj_id >= 0 AND leaf_ok[m, t] > 0,
//   kw    = any(obj_bm[w] & q_bm[m, w]) over the words,
//   inr   = the point lies in the closed query rectangle,
// and write ids[m, t*OBJ + o] = obj_id if inr & kw & valid else -1. The
// per-slot count kwv[m, t] sums kw & valid -- keyword hits outside the
// rectangle included (fused_verify.py:103, :172): it is the Eq. 1
// ``verified`` count. So the word test runs for every valid object and the
// rectangle test must not gate it; the rectangle is read only for keyword
// hits.
//
// What bounds them on the H100: bytes. At the osm profile an object's row
// is W = 256 words (1 KiB); the work per byte is one AND.
//   - The tile kernel reads a row only at the query's packed words
//     (ops.pack_query_words: at most Wp, the batch's largest count of
//     nonzero query words, 8 for the 5-keyword MIX queries), since no other
//     word can hit, its loads issued together (wisk::pairs_hit), and stops
//     after a hit: a miss costs a few 32-byte sectors, not 1 KiB. Each block
//     stages its BM queries' (id, value) word pairs (2 * BM * Wp ints, so W
//     does not cap the tile), their TC slots' leaf rows and their counts in
//     shared memory. The grid is query tiles
//     x slot chunks -- 1024 blocks at M = 1024, T = 32, several per SM --
//     and neighbouring threads take neighbouring objects of one leaf row,
//     so the object ids, coordinates and output ids are read and written
//     coalesced. kwv is summed with shared-memory atomics and written once
//     by the block that owns the (query, slot) pair.
//   - The (M, T) kernel keeps the TPU kernel's decomposition, one block per
//     (query, slot), with one thread per object: neighbouring threads read
//     neighbouring object ids and coordinates and write neighbouring ids,
//     and kwv is a warp-shuffle and shared-memory sum written once. The
//     block compacts query m's W words into (word id, value) pairs of its
//     nonzero words in shared memory (warp ballots and prefix counts, no
//     atomics; rounds of kRoundWords words, so W is not capped), and each
//     thread tests its object's row only at those ids. A miss needs every
//     nonzero word, so the word loads of a group of pairs are issued as
//     independent loads (wisk::pairs_hit) rather than as a load-then-branch
//     chain; a hit stops after its group. The rectangle and coordinates
//     are read only after a hit. A leaf_ok = 0 slot writes -1s and a zero
//     count and reads nothing else.
//     Each word read is one scattered 32-byte sector (neighbouring objects'
//     rows are 1 KiB apart), where the bound counts its 4 bytes: at the
//     osm main path, where most objects miss against 5 keywords, the word
//     reads move up to 8x the bytes the bound counts for them.
//
// This is the simple version that is right first: no vector loads, no TMA.
// The outputs are bit-identical to the reference: only floats are compared
// and counts are integer sums.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
using wisk::kRoundWords;

struct Bank {
  const float* q_rects;      // (M, 4)
  const int32_t* q_bm;       // (M, W): the (M, T) kernel's query words
  const int32_t* q_wids;     // (M, Wp): the tile kernel's packed word ids
  const int32_t* q_bits;     // (M, Wp): ... and their values
  const int32_t* top_leaf;   // (M, T)
  const int8_t* leaf_ok;     // (M, T)
  const float* obj_x;        // (K, OBJ)
  const float* obj_y;        // (K, OBJ)
  const int32_t* obj_bm;     // (K, OBJ, W)
  const int32_t* obj_id;     // (K, OBJ)
  int32_t* ids;              // (M, T * OBJ)
  int32_t* kwv;              // (M, T)
  int M, T, K, OBJ, W, Wp;
};

// The leaf row a (query, slot) pair reads: dirty ids clamp like the reference.
__device__ __forceinline__ int64_t leaf_row(const Bank& b, int64_t pair) {
  int leaf = __ldg(b.top_leaf + pair);
  leaf = min(max(leaf, 0), b.K - 1);
  return (int64_t)leaf * b.OBJ;
}

// variant="vmem": one block per tile of BM queries (grid x) and TC slots
// (grid y), one thread per object. Shared memory holds the tile's packed
// query words (2 * BM * Wp ints), its slots' leaf rows (-1 where leaf_ok
// is 0) and its per-slot counts (BM * TC ints each).
__global__ void fused_verify_wide_tile_kernel(Bank b, int BM, int TC) {
  extern __shared__ int32_t s_mem[];
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int t0 = blockIdx.y * TC;
  const int rows = (int)min((int64_t)BM, (int64_t)b.M - m0);
  const int cols = min(TC, b.T - t0);
  const int n_pairs = rows * cols;  // local pair l = r * cols + c
  int32_t* s_wid = s_mem;                      // (rows, Wp)
  int32_t* s_bit = s_wid + BM * b.Wp;          // (rows, Wp)
  int32_t* s_leaf = s_bit + BM * b.Wp;         // (n_pairs,)
  int* s_kwv = s_leaf + BM * TC;               // (n_pairs,)
  wisk::stage_packed_words(s_wid, s_bit, b.q_wids + m0 * b.Wp, b.q_bits + m0 * b.Wp,
                           rows * b.Wp, b.W);
  for (int l = threadIdx.x; l < n_pairs; l += blockDim.x) {
    const int64_t pair = (m0 + l / cols) * b.T + t0 + l % cols;
    const int leaf = min(max(__ldg(b.top_leaf + pair), 0), b.K - 1);
    s_leaf[l] = __ldg(b.leaf_ok + pair) > 0 ? leaf : -1;
    s_kwv[l] = 0;
  }
  __syncthreads();
  const int total = n_pairs * b.OBJ;  // the wrapper keeps BM * TC * OBJ in range
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l = i / b.OBJ;
    const int o = i - l * b.OBJ;
    const int r = l / cols;
    const int64_t m = m0 + r;
    const int64_t pair = m * b.T + t0 + (l - r * cols);
    int32_t out = -1;
    if (s_leaf[l] >= 0) {
      const int64_t obj = (int64_t)s_leaf[l] * b.OBJ + o;
      const int32_t cid = __ldg(b.obj_id + obj);
      if (cid >= 0 && wisk::pairs_hit(b.obj_bm + obj * b.W, s_wid + r * b.Wp, s_bit + r * b.Wp,
                                       b.Wp)) {
        atomicAdd(&s_kwv[l], 1);
        if (wisk::point_in_rect(b.q_rects + m * 4, __ldg(b.obj_x + obj),
                                __ldg(b.obj_y + obj))) {
          out = cid;
        }
      }
    }
    b.ids[pair * b.OBJ + o] = out;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n_pairs; l += blockDim.x) {
    b.kwv[(m0 + l / cols) * b.T + t0 + l % cols] = s_kwv[l];
  }
}

// variant="prefetch": one block per (query, slot), one thread per object
// (threads stride over the row when OBJ exceeds the block). The query's
// nonzero words are compacted once (or once per round and object pass when
// W exceeds kRoundWords); the block reduces kwv.
__global__ void fused_verify_wide_slot_kernel(Bank b) {
  extern __shared__ int32_t s_mem[];  // (round,) word ids, then (round,) values
  __shared__ int s_cnt[kWarpsPerBlock];
  __shared__ int s_sum[kWarpsPerBlock];
  const int64_t pair = blockIdx.x;
  const int64_t m = pair / b.T;
  int32_t* ids = b.ids + pair * b.OBJ;
  if (__ldg(b.leaf_ok + pair) <= 0) {  // the whole block: nothing is valid
    for (int o = threadIdx.x; o < b.OBJ; o += blockDim.x) ids[o] = -1;
    if (threadIdx.x == 0) b.kwv[pair] = 0;
    return;
  }
  const int round = min(b.W, kRoundWords);
  int32_t* s_wid = s_mem;
  int32_t* s_bit = s_mem + round;
  const int32_t* q = b.q_bm + m * b.W;
  const int64_t row = leaf_row(b, pair);
  const int rounds = (b.W + kRoundWords - 1) / kRoundWords;
  int n = 0;
  int local = 0;
  for (int o0 = 0; o0 < b.OBJ; o0 += blockDim.x) {  // block-uniform trip count
    const int o = o0 + threadIdx.x;
    const int64_t obj = row + o;
    const int32_t cid = o < b.OBJ ? __ldg(b.obj_id + obj) : -1;
    bool kw = false;
    for (int r = 0; r < rounds; ++r) {
      if (rounds > 1 || o0 == 0) {
        if (r > 0 || o0 > 0) __syncthreads();  // the last pairs are read
        const int w0 = r * kRoundWords;
        n = wisk::compact_words(s_wid, s_bit, s_cnt, q, w0, min(kRoundWords, b.W - w0));
      }
      if (cid >= 0 && !kw) kw = wisk::pairs_hit(b.obj_bm + obj * b.W, s_wid, s_bit, n);
    }
    if (o < b.OBJ) {
      int32_t out = -1;
      if (kw) {
        ++local;
        if (wisk::point_in_rect(b.q_rects + m * 4, __ldg(b.obj_x + obj), __ldg(b.obj_y + obj))) {
          out = cid;
        }
      }
      ids[o] = out;
    }
  }
  for (int d = 16; d > 0; d >>= 1) local += __shfl_down_sync(0xffffffffu, local, d);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += s_sum[w];
    b.kwv[pair] = sum;
  }
}

Bank make_bank(const void* q_rects, const void* q_bm, const void* q_wids,
               const void* q_bits, const void* top_leaf, const void* leaf_ok,
               const void* obj_x, const void* obj_y, const void* obj_bm,
               const void* obj_id, void* ids, void* kwv, int M, int T, int K,
               int OBJ, int W, int Wp) {
  Bank b;
  b.q_rects = (const float*)q_rects;
  b.q_bm = (const int32_t*)q_bm;
  b.q_wids = (const int32_t*)q_wids;
  b.q_bits = (const int32_t*)q_bits;
  b.top_leaf = (const int32_t*)top_leaf;
  b.leaf_ok = (const int8_t*)leaf_ok;
  b.obj_x = (const float*)obj_x;
  b.obj_y = (const float*)obj_y;
  b.obj_bm = (const int32_t*)obj_bm;
  b.obj_id = (const int32_t*)obj_id;
  b.ids = (int32_t*)ids;
  b.kwv = (int32_t*)kwv;
  b.M = M;
  b.T = T;
  b.K = K;
  b.OBJ = OBJ;
  b.W = W;
  b.Wp = Wp;
  return b;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (PyTorch's current stream) and
// return cudaGetLastError(); the Python wrapper raises on anything but 0.
// The tile kernel's wrapper keeps its dynamic shared memory at or below
// 32 KiB, inside the default 48 KB a block may take without opting in, and
// T / TC within the grid's second dimension; the (M, T) kernel takes at
// most 16 KiB of pairs, whatever W is.
int wisk_fused_verify_tile(const void* q_rects, const void* q_wids,
                           const void* q_bits, const void* top_leaf,
                           const void* leaf_ok, const void* obj_x,
                           const void* obj_y, const void* obj_bm,
                           const void* obj_id, void* ids, void* kwv, int M,
                           int T, int K, int OBJ, int W, int Wp, int BM, int TC,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && T > 0) {
    Bank b = make_bank(q_rects, nullptr, q_wids, q_bits, top_leaf, leaf_ok, obj_x,
                       obj_y, obj_bm, obj_id, ids, kwv, M, T, K, OBJ, W, Wp);
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((T + TC - 1) / TC));
    const size_t smem = (size_t)(2 * BM * Wp + 2 * BM * TC) * sizeof(int32_t);
    fused_verify_wide_tile_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(b, BM, TC);
  }
  return (int)cudaGetLastError();
}

int wisk_fused_verify_slot(const void* q_rects, const void* q_bm,
                           const void* top_leaf, const void* leaf_ok,
                           const void* obj_x, const void* obj_y,
                           const void* obj_bm, const void* obj_id, void* ids,
                           void* kwv, int M, int T, int K, int OBJ, int W,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && T > 0) {
    Bank b = make_bank(q_rects, q_bm, nullptr, nullptr, top_leaf, leaf_ok, obj_x,
                       obj_y, obj_bm, obj_id, ids, kwv, M, T, K, OBJ, W, 0);
    const int threads = OBJ >= kThreads ? kThreads : ((OBJ + 31) / 32) * 32;
    const size_t smem = 2 * (size_t)min(W, kRoundWords) * sizeof(int32_t);
    fused_verify_wide_slot_kernel<<<(unsigned)((int64_t)M * T), threads, smem,
                                    (cudaStream_t)stream>>>(b);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
