// Boolean-kNN frontier distance filters for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 7 and 8 of the port's kernel table):
//   src/repro/kernels/knn_filter.py::knn_filter_narrow -> wisk_knn_filter_narrow
//     (int16 MBR rank codes + packed query word planes, the default descent);
//   src/repro/kernels/knn_filter.py::knn_filter        -> wisk_knn_level_dist
//     (f32 MBRs and full-width bitmap words: quantized=False, a snapshot
//     without narrow planes, or a live delta's widened level arrays).
// Oracles: kernels/ref.py knn_filter_narrow_ref / knn_level_dist_ref (which
// equals knn_filter_ref on the gathered planes).
//
// Both share one predicate and one distance (slot_predicates.cuh): for each
// (query point m, frontier slot f), out = the squared min-distance from the
// point to the slot's closed MBR, or +inf where the slot is invalid or none
// of its bitmap words ANDs non-zero with the query's. Output (M, F) f32.
//
// Exactness: dx*dx + dy*dy is computed with __fmul_rn / __fadd_rn, which
// nvcc never contracts into a fused multiply-add (it does by default for
// a*a + b*b under -O3), so the distances equal the plain PyTorch version
// and the host oracle core/query.py _mbr_dist2_f32 bit for bit.
//
// What bounds them on the H100: bytes. Per slot about ten flops against an
// MBR of 16 bytes (or 8 of codes plus dictionary reads) and the words.
//   - Narrow: the caller gathers the (M, F, Wp) packed word plane and the
//     codes; one thread per (query, slot) reads them, the dictionaries
//     through the read-only path, the codes only for slots whose words hit.
//   - Full width (wisk_knn_level_dist): the kernel gathers for itself from
//     the level arrays, so no (M, F, W) plane is ever made (8.6 GB at the
//     leaf level of a 1024-query batch, F = 8192, W = 256). Only a word
//     where the query's word is nonzero can hit, so a slot reads at most the
//     query's Wp packed words (ops.pack_query_words) of its node's row,
//     stopping at the first hit, and its MBR only after a hit; a padding
//     slot (id -1, most of a wide frontier) reads nothing past its id. What
//     is left is the (M, F) ids in and distances out, read and written
//     coalesced, and the scattered 4-byte word reads of valid slots.
//
// This is the simple version that is right first: no vector loads, and the
// scattered word reads go one sector each through L1/L2.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void knn_narrow_kernel(
    const float* __restrict__ q_pts,       // (M, 2)
    const int32_t* __restrict__ q_bits,    // (M, Wp)
    const int16_t* __restrict__ f_codes,   // (M, F, 4)
    const int32_t* __restrict__ f_bm,      // (M, F, Wp)
    const int8_t* __restrict__ f_valid,    // (M, F)
    const float* __restrict__ dict_x,      // (Dx,)
    const float* __restrict__ dict_y,      // (Dy,)
    float* __restrict__ out,               // (M, F)
    int M, int F, int Wp, int Dx, int Dy) {
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (int64_t)M * F) return;
  const int64_t m = slot / F;
  float d = INFINITY;
  if (__ldg(f_valid + slot) > 0 &&
      wisk::words_hit_thread(f_bm + slot * Wp, q_bits + m * Wp, Wp)) {
    const float4 b = wisk::dequantize_mbr(f_codes + slot * 4, dict_x, dict_y, Dx, Dy);
    d = wisk::mbr_dist2(__ldg(q_pts + m * 2), __ldg(q_pts + m * 2 + 1), b);
  }
  out[slot] = d;
}

// One thread per (query m, frontier slot f): blocks of consecutive slots of
// one query, so neighbouring threads read neighbouring frontier ids and
// write neighbouring distances. The block stages query m's packed words;
// a slot reads level_bms[node, wid] for them, stopping at the first hit,
// and its MBR only after a hit.
__global__ void knn_level_kernel(
    const float* __restrict__ q_pts,         // (M, 2)
    const int32_t* __restrict__ q_wids,      // (M, Wp) word ids
    const int32_t* __restrict__ q_bits,      // (M, Wp) word values
    const float* __restrict__ level_mbrs,    // (N, 4)
    const int32_t* __restrict__ level_bms,   // (N, W)
    const int32_t* __restrict__ frontier,    // (M, F), -1 = empty slot
    float* __restrict__ out,                 // (M, F)
    int F, int Wp, int N, int W, int chunks) {
  extern __shared__ int32_t s_words[];  // word ids (Wp), then values (Wp)
  int32_t* s_wid = s_words;
  int32_t* s_bit = s_words + Wp;
  const int64_t m = blockIdx.x / chunks;
  const int f = (int)(blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  wisk::stage_packed_words(s_wid, s_bit, q_wids + m * Wp, q_bits + m * Wp, Wp, W);
  __syncthreads();
  if (f >= F) return;
  const int64_t slot = m * F + f;
  const int32_t id = __ldg(frontier + slot);
  float d = INFINITY;
  if (id >= 0) {
    const int64_t node = min(id, N - 1);  // dirty ids clamp like the gather
    if (wisk::packed_words_hit(level_bms + node * W, s_wid, s_bit, Wp)) {
      d = wisk::mbr_dist2(__ldg(q_pts + m * 2), __ldg(q_pts + m * 2 + 1),
                          wisk::load_mbr(level_mbrs + node * 4));
    }
  }
  out[slot] = d;
}

unsigned grid_for(int64_t n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_knn_filter_narrow(const void* q_pts, const void* q_bits,
                           const void* f_codes, const void* f_bm,
                           const void* f_valid, const void* dict_x,
                           const void* dict_y, void* out, int M, int F, int Wp,
                           int Dx, int Dy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * F;
  if (n > 0) {
    knn_narrow_kernel<<<grid_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)q_pts, (const int32_t*)q_bits, (const int16_t*)f_codes,
        (const int32_t*)f_bm, (const int8_t*)f_valid, (const float*)dict_x,
        (const float*)dict_y, (float*)out, M, F, Wp, Dx, Dy);
  }
  return (int)cudaGetLastError();
}

// The block size follows F (a multiple of 32, at most kThreads), so the
// narrow frontiers near the root do not idle most of a block.
int wisk_knn_level_dist(const void* q_pts, const void* q_wids, const void* q_bits,
                        const void* level_mbrs, const void* level_bms,
                        const void* frontier, void* out, int M, int F, int Wp,
                        int N, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)M * F > 0) {
    const int threads = F >= kThreads ? kThreads : ((F + 31) / 32) * 32;
    const int chunks = (F + threads - 1) / threads;
    const size_t smem = 2 * (size_t)Wp * sizeof(int32_t);
    knn_level_kernel<<<(unsigned)((int64_t)M * chunks), threads, smem,
                       (cudaStream_t)stream>>>(
        (const float*)q_pts, (const int32_t*)q_wids, (const int32_t*)q_bits,
        (const float*)level_mbrs, (const int32_t*)level_bms,
        (const int32_t*)frontier, (float*)out, F, Wp, N, W, chunks);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
