// Fused leaf gather + verify on the compact leaf bank, for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 2 and 3 of the port's kernel table):
//   src/repro/kernels/fused_verify.py::fused_verify_compact           -> the
//     query-tile kernel below (variant="vmem"): one block per BM queries,
//     looping over the T selected leaf slots of each query;
//   src/repro/kernels/fused_verify.py::fused_verify_prefetch_compact  -> the
//     (M, T) kernel below (variant="prefetch", and "auto"): one block per
//     (query, slot), its threads striding over the leaf row's objects.
// Oracle: kernels/ref.py fused_verify_compact_ref in this package. The
// full-width twins are in fused_verify.cu.
//
// Both launches share one __device__ predicate per object: gather the
// object of leaf clamp(top_leaf[m, t], 0, K-1) (the clamp of
// fused_verify.py:243 and :364), then
//   inr   = the point lies in the closed query rectangle,
//   kw    = (obj_sig & q_sig) != 0 AND any(obj_cbm[w] & q_cbm[m, t, w]),
//   valid = obj_id >= 0 AND leaf_ok[m, t] > 0,
// and write ids[m, t*OBJ + o] = obj_id if inr & kw & valid else -1. The
// per-slot count kwv[m, t] sums kw & valid -- keyword hits outside the
// rectangle included: it is the Eq. 1 ``verified`` count, not the number of
// matches. The signature test is a prefilter: the word loop only runs when
// it passes, which cannot change kw (an overlapping word always sets a
// shared signature bit).
//
// What bounds it on the H100: bytes gathered from HBM and L2, not
// arithmetic. Each (query, slot) pulls one leaf row -- OBJ x (x, y, id, sig)
// plus the Wl-word compact slab of the objects whose signature passes -- and
// writes OBJ ids; the work per byte is a few compares and ANDs. The (M, T)
// kernel gives each gathered row its own block so many rows are in flight;
// the query-tile kernel walks a tile's rows in order with every thread of
// the block on consecutive objects, so its loads and the id stores stay
// coalesced.
//
// This is the simple version that is right first: no shared-memory staging
// of the rows, no vector loads, no TMA. The outputs are bit-identical to the
// reference: only floats are compared and counts are integer sums.
#include "slot_predicates.cuh"

namespace {

struct Bank {
  const float* q_rects;      // (M, 4)
  const int32_t* q_cbm;      // (M, T, Wl)
  const int32_t* q_sig;      // (M, T)
  const int32_t* top_leaf;   // (M, T)
  const int8_t* leaf_ok;     // (M, T)
  const float* obj_x;        // (K, OBJ)
  const float* obj_y;        // (K, OBJ)
  const int32_t* obj_cbm;    // (K, OBJ, Wl)
  const int32_t* obj_sig;    // (K, OBJ)
  const int32_t* obj_id;     // (K, OBJ)
  int32_t* ids;              // (M, T * OBJ)
  int32_t* kwv;              // (M, T)
  int M, T, K, OBJ, Wl;
};

// The leaf row a (query, slot) pair reads: dirty ids clamp like the reference.
__device__ __forceinline__ int64_t leaf_row(const Bank& b, int64_t pair) {
  int leaf = __ldg(b.top_leaf + pair);
  leaf = min(max(leaf, 0), b.K - 1);
  return (int64_t)leaf * b.OBJ;
}

// The per-object predicate shared by both launches. Writes the object's id
// slot and returns 1 when the object counts toward kwv (kw & valid).
__device__ __forceinline__ int verify_object(const Bank& b, int64_t m,
                                             int64_t pair, int64_t row,
                                             int o) {
  const int64_t obj = row + o;
  const int32_t cid = __ldg(b.obj_id + obj);
  const bool valid = cid >= 0 && __ldg(b.leaf_ok + pair) > 0;
  bool kw = false;
  if (valid && (__ldg(b.obj_sig + obj) & __ldg(b.q_sig + pair)) != 0) {
    const int32_t* cb = b.obj_cbm + obj * b.Wl;
    const int32_t* qc = b.q_cbm + pair * b.Wl;
    for (int w = 0; w < b.Wl; ++w) {
      if ((__ldg(cb + w) & __ldg(qc + w)) != 0) {
        kw = true;
        break;
      }
    }
  }
  const bool inr = kw && wisk::point_in_rect(b.q_rects + m * 4, __ldg(b.obj_x + obj),
                                             __ldg(b.obj_y + obj));
  b.ids[pair * b.OBJ + o] = inr ? cid : -1;
  return kw ? 1 : 0;
}

// variant="vmem": one block per tile of BM queries; counts gather in shared
// memory (BM * T ints) and are written once at the end.
__global__ void fused_verify_tile_kernel(Bank b, int BM) {
  extern __shared__ int s_kwv[];
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int rows = (int)min((int64_t)BM, (int64_t)b.M - m0);
  const int n_cnt = rows * b.T;
  for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) s_kwv[i] = 0;
  __syncthreads();
  const int64_t per_q = (int64_t)b.T * b.OBJ;
  const int64_t total = rows * per_q;
  for (int64_t i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = (int)(i / per_q);
    const int64_t j = i - r * per_q;
    const int t = (int)(j / b.OBJ);
    const int o = (int)(j - (int64_t)t * b.OBJ);
    const int64_t m = m0 + r;
    const int64_t pair = m * b.T + t;
    if (verify_object(b, m, pair, leaf_row(b, pair), o)) {
      atomicAdd(&s_kwv[r * b.T + t], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) {
    b.kwv[m0 * b.T + i] = s_kwv[i];
  }
}

// variant="prefetch": one block per (query, slot); the block reduces kwv.
__global__ void fused_verify_slot_kernel(Bank b) {
  __shared__ int s_warp[32];
  const int64_t pair = blockIdx.x;
  const int64_t m = pair / b.T;
  const int64_t row = leaf_row(b, pair);
  int local = 0;
  for (int o = threadIdx.x; o < b.OBJ; o += blockDim.x) {
    local += verify_object(b, m, pair, row, o);
  }
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    const int n_warps = (blockDim.x + 31) >> 5;
    for (int w = 0; w < n_warps; ++w) sum += s_warp[w];
    b.kwv[pair] = sum;
  }
}

Bank make_bank(const void* q_rects, const void* q_cbm, const void* q_sig,
               const void* top_leaf, const void* leaf_ok, const void* obj_x,
               const void* obj_y, const void* obj_cbm, const void* obj_sig,
               const void* obj_id, void* ids, void* kwv, int M, int T, int K,
               int OBJ, int Wl) {
  Bank b;
  b.q_rects = (const float*)q_rects;
  b.q_cbm = (const int32_t*)q_cbm;
  b.q_sig = (const int32_t*)q_sig;
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

}  // namespace

extern "C" {

// Both entry points launch on `stream` (PyTorch's current stream) and
// return cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_fused_verify_compact_tile(
    const void* q_rects, const void* q_cbm, const void* q_sig,
    const void* top_leaf, const void* leaf_ok, const void* obj_x,
    const void* obj_y, const void* obj_cbm, const void* obj_sig,
    const void* obj_id, void* ids, void* kwv, int M, int T, int K, int OBJ,
    int Wl, int BM, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && T > 0) {
    Bank b = make_bank(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y,
                       obj_cbm, obj_sig, obj_id, ids, kwv, M, T, K, OBJ, Wl);
    const unsigned blocks = (unsigned)((M + BM - 1) / BM);
    const size_t smem = (size_t)BM * T * sizeof(int);
    fused_verify_tile_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(b, BM);
  }
  return (int)cudaGetLastError();
}

int wisk_fused_verify_compact_slot(
    const void* q_rects, const void* q_cbm, const void* q_sig,
    const void* top_leaf, const void* leaf_ok, const void* obj_x,
    const void* obj_y, const void* obj_cbm, const void* obj_sig,
    const void* obj_id, void* ids, void* kwv, int M, int T, int K, int OBJ,
    int Wl, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && T > 0) {
    Bank b = make_bank(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y,
                       obj_cbm, obj_sig, obj_id, ids, kwv, M, T, K, OBJ, Wl);
    int threads = ((OBJ + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
    const unsigned blocks = (unsigned)((int64_t)M * T);
    fused_verify_slot_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(b);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
