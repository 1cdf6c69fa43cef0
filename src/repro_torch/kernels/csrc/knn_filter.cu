// Boolean-kNN frontier distance filters for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 7 and 8 of the port's kernel table):
//   src/repro/kernels/knn_filter.py::knn_filter_narrow -> wisk_knn_filter_narrow
//     (int16 MBR rank codes + packed query word planes, the default descent);
//   src/repro/kernels/knn_filter.py::knn_filter        -> wisk_knn_filter
//     (f32 MBRs + all W bitmap words: quantized=False, or a snapshot without
//     narrow planes).
// Oracles: kernels/ref.py knn_filter_narrow_ref / knn_filter_ref.
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
// What bounds them on the H100: bytes. Per slot about ten flops against
// 16 bytes of MBR (or 8 of codes plus dictionary reads) and up to W words.
//   - Narrow: Wp words per slot (a few), one thread per (query, slot); the
//     dictionaries are read through the read-only path, the codes only for
//     slots whose words hit.
//   - Full width: W = 256 words per slot at the osm profile. One warp per
//     slot, lanes on neighbouring words (coalesced 128-byte rows), stopping
//     at the first 32-word stride that holds a hit; the MBR is read only when
//     the keyword test passes.
//
// This is the simple version that is right first: no shared-memory staging,
// no vector loads.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

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

__global__ void knn_filter_kernel(
    const float* __restrict__ q_pts,       // (M, 2)
    const int32_t* __restrict__ q_bm,      // (M, W)
    const float* __restrict__ f_mbrs,      // (M, F, 4)
    const int32_t* __restrict__ f_bm,      // (M, F, W)
    const int8_t* __restrict__ f_valid,    // (M, F)
    float* __restrict__ out,               // (M, F)
    int M, int F, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= (int64_t)M * F) return;  // warp-uniform: the whole warp leaves
  const int64_t m = slot / F;
  float d = INFINITY;
  if (__ldg(f_valid + slot) > 0 &&
      wisk::words_hit_warp(f_bm + slot * W, q_bm + m * W, W, lane)) {
    d = wisk::mbr_dist2(__ldg(q_pts + m * 2), __ldg(q_pts + m * 2 + 1),
                        wisk::load_mbr(f_mbrs + slot * 4));
  }
  if (lane == 0) out[slot] = d;
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

int wisk_knn_filter(const void* q_pts, const void* q_bm, const void* f_mbrs,
                    const void* f_bm, const void* f_valid, void* out, int M,
                    int F, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * F;
  if (n > 0) {
    knn_filter_kernel<<<grid_for(n, kWarpsPerBlock), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)q_pts, (const int32_t*)q_bm, (const float*)f_mbrs,
        (const int32_t*)f_bm, (const int8_t*)f_valid, (float*)out, M, F, W);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
