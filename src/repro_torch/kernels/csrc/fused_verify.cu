// Fused leaf gather + verify on the full-width leaf bank, for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 5 and 6 of the port's kernel table):
//   src/repro/kernels/fused_verify.py::fused_verify          -> the query-tile
//     kernel below (variant="vmem"): one block per BM queries, looping over
//     the T selected leaf slots of each query;
//   src/repro/kernels/fused_verify.py::fused_verify_prefetch -> the (M, T)
//     kernel below (variant="prefetch", and "auto"): one block per (query,
//     slot), its warps striding over the leaf row's objects.
// They serve compact=False, a snapshot without a compact bank (a leaf
// dictionary above LEAF_DICT_MAX), and the base blocks of a live delta over
// such a snapshot. Oracle: kernels/ref.py fused_verify_ref. The compact
// twins are in fused_verify_compact.cu.
//
// Both launches share one __device__ predicate per object, run by one warp:
// gather the object of leaf clamp(top_leaf[m, t], 0, K-1) (the clamp of
// fused_verify.py:86 and :197), then
//   valid = obj_id >= 0 AND leaf_ok[m, t] > 0,
//   kw    = any(obj_bm[w] & q_bm[m, w]) over all W words,
//   inr   = the point lies in the closed query rectangle,
// and write ids[m, t*OBJ + o] = obj_id if inr & kw & valid else -1. The
// per-slot count kwv[m, t] sums kw & valid -- keyword hits outside the
// rectangle included (fused_verify.py:103, :172): it is the Eq. 1
// ``verified`` count. So the word loop runs for every valid object and the
// rectangle test must not gate it; the rectangle is read only for keyword
// hits.
//
// What bounds it on the H100: bytes. At the osm profile an object's row is
// W = 256 words (1 KiB), and a row with no hit is read whole; the work per
// byte is one AND. Each block stages its queries' W words in shared memory
// once (1 KiB a query), so the loop reads only the bank from device memory.
// The warp's lanes read neighbouring words of the row (coalesced 128-byte
// rows) and stop at the first 32-word stride that holds a hit.
//
// This is the simple version that is right first: no vector loads, no TMA,
// no restriction to the query's nonzero words. The outputs are bit-identical
// to the reference: only floats are compared and counts are integer sums.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

struct Bank {
  const float* q_rects;      // (M, 4)
  const int32_t* q_bm;       // (M, W)
  const int32_t* top_leaf;   // (M, T)
  const int8_t* leaf_ok;     // (M, T)
  const float* obj_x;        // (K, OBJ)
  const float* obj_y;        // (K, OBJ)
  const int32_t* obj_bm;     // (K, OBJ, W)
  const int32_t* obj_id;     // (K, OBJ)
  int32_t* ids;              // (M, T * OBJ)
  int32_t* kwv;              // (M, T)
  int M, T, K, OBJ, W;
};

// The leaf row a (query, slot) pair reads: dirty ids clamp like the reference.
__device__ __forceinline__ int64_t leaf_row(const Bank& b, int64_t pair) {
  int leaf = __ldg(b.top_leaf + pair);
  leaf = min(max(leaf, 0), b.K - 1);
  return (int64_t)leaf * b.OBJ;
}

// One object, by a whole warp (every branch is warp-uniform). `s_q` holds
// query m's W words in shared memory. Lane 0 writes the id slot; returns 1
// on every lane when the object counts toward kwv (kw & valid).
__device__ __forceinline__ int verify_object(const Bank& b, const int32_t* s_q,
                                             int64_t m, int64_t pair, int64_t row,
                                             int o, int lane) {
  const int64_t obj = row + o;
  const int32_t cid = __ldg(b.obj_id + obj);
  const bool valid = cid >= 0 && __ldg(b.leaf_ok + pair) > 0;
  const bool kw = valid && wisk::words_hit_warp<true>(b.obj_bm + obj * b.W, s_q, b.W, lane);
  const bool inr = kw && wisk::point_in_rect(b.q_rects + m * 4, __ldg(b.obj_x + obj),
                                             __ldg(b.obj_y + obj));
  if (lane == 0) b.ids[pair * b.OBJ + o] = inr ? cid : -1;
  return kw ? 1 : 0;
}

// variant="vmem": one block per tile of BM queries. Shared memory holds the
// tile's query words (BM * W ints) and its per-slot counts (BM * T ints),
// written once at the end.
__global__ void fused_verify_wide_tile_kernel(Bank b, int BM) {
  extern __shared__ int32_t s_mem[];
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int rows = (int)min((int64_t)BM, (int64_t)b.M - m0);
  int32_t* s_q = s_mem;                            // (rows, W)
  int* s_kwv = s_mem + (int64_t)BM * b.W;          // (rows, T)
  wisk::stage_words(s_q, b.q_bm + m0 * b.W, rows * b.W);
  const int n_cnt = rows * b.T;
  for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) s_kwv[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t per_q = (int64_t)b.T * b.OBJ;
  const int64_t total = rows * per_q;
  for (int64_t i = threadIdx.x >> 5; i < total; i += kWarpsPerBlock) {
    const int r = (int)(i / per_q);
    const int64_t j = i - r * per_q;
    const int t = (int)(j / b.OBJ);
    const int o = (int)(j - (int64_t)t * b.OBJ);
    const int64_t m = m0 + r;
    const int64_t pair = m * b.T + t;
    if (verify_object(b, s_q + (int64_t)r * b.W, m, pair, leaf_row(b, pair), o, lane) &&
        lane == 0) {
      atomicAdd(&s_kwv[r * b.T + t], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) {
    b.kwv[m0 * b.T + i] = s_kwv[i];
  }
}

// variant="prefetch": one block per (query, slot); the block reduces kwv.
__global__ void fused_verify_wide_slot_kernel(Bank b) {
  extern __shared__ int32_t s_q[];  // (W,) query m's words
  __shared__ int s_warp[kWarpsPerBlock];
  const int64_t pair = blockIdx.x;
  const int64_t m = pair / b.T;
  const int64_t row = leaf_row(b, pair);
  wisk::stage_words(s_q, b.q_bm + m * b.W, b.W);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int local = 0;
  for (int o = warp; o < b.OBJ; o += n_warps) {
    local += verify_object(b, s_q, m, pair, row, o, lane);
  }
  if (lane == 0) s_warp[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < n_warps; ++w) sum += s_warp[w];
    b.kwv[pair] = sum;
  }
}

Bank make_bank(const void* q_rects, const void* q_bm, const void* top_leaf,
               const void* leaf_ok, const void* obj_x, const void* obj_y,
               const void* obj_bm, const void* obj_id, void* ids, void* kwv,
               int M, int T, int K, int OBJ, int W) {
  Bank b;
  b.q_rects = (const float*)q_rects;
  b.q_bm = (const int32_t*)q_bm;
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
  return b;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (PyTorch's current stream) and
// return cudaGetLastError(); the Python wrapper raises on anything but 0.
// The wrapper keeps the dynamic shared memory at or below 32 KiB, inside
// the default 48 KB a block may take without opting in.
int wisk_fused_verify_tile(const void* q_rects, const void* q_bm,
                           const void* top_leaf, const void* leaf_ok,
                           const void* obj_x, const void* obj_y,
                           const void* obj_bm, const void* obj_id, void* ids,
                           void* kwv, int M, int T, int K, int OBJ, int W,
                           int BM, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && T > 0) {
    Bank b = make_bank(q_rects, q_bm, top_leaf, leaf_ok, obj_x, obj_y, obj_bm,
                       obj_id, ids, kwv, M, T, K, OBJ, W);
    const unsigned blocks = (unsigned)((M + BM - 1) / BM);
    const size_t smem = (size_t)BM * (W + T) * sizeof(int32_t);
    fused_verify_wide_tile_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(b, BM);
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
    Bank b = make_bank(q_rects, q_bm, top_leaf, leaf_ok, obj_x, obj_y, obj_bm,
                       obj_id, ids, kwv, M, T, K, OBJ, W);
    const int warps = OBJ < 1 ? 1 : (OBJ < kWarpsPerBlock ? OBJ : kWarpsPerBlock);
    const int threads = 32 * warps;
    const size_t smem = (size_t)W * sizeof(int32_t);
    fused_verify_wide_slot_kernel<<<(unsigned)((int64_t)M * T), threads, smem,
                               (cudaStream_t)stream>>>(b);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
