// Frontier filters for Hopper (sm_90a): the range descent's per-level
// survivor test, on the bandwidth-lean planes and on the f32 full-width ones.
//
// Replaces two TPU kernels (rows 1 and 4 of the port's kernel table):
//   src/repro/kernels/frontier.py::frontier_filter_narrow -> wisk_frontier_narrow
//     (int16 MBR rank codes + packed query word planes, the default descent);
//   src/repro/kernels/frontier.py::frontier_filter        -> wisk_frontier_filter
//     (f32 MBRs + all W bitmap words: quantized=False, or a snapshot whose
//     coordinate dictionaries overflowed int16 and carries no narrow planes).
// Oracles: kernels/ref.py frontier_filter_narrow_ref / frontier_filter_ref.
//
// Both share one predicate (slot_predicates.cuh): for each (query m,
// frontier slot f), the slot is valid, its MBR meets the query's closed
// rectangle, and one of its bitmap words ANDs non-zero with the query's.
// Output (M, F) int8. Only floats are compared, so the survivor matrix is
// bit-identical to the reference.
//
// What bounds them on the H100: bytes. Per slot a few compares against
// 16 bytes of MBR (or 8 of codes plus dictionary reads) and up to W words:
// far below one operation per byte at the card's rate.
//   - Narrow: Wp (a power of two, at most 8 at the MIX workload's five
//     keywords) words per slot, so one thread per (query, slot) reads its
//     words in a short loop.
//   - Full width: W = 256 words (1 KiB) per slot at the osm profile, and the
//     gathered (M, F, W) plane is the largest operand of the descent (268 MB
//     at M = 1024, F = 256). One warp per slot, lanes on neighbouring words,
//     so every load is a coalesced 128-byte row; the warp stops at the first
//     32-word stride that holds a hit, and skips the words of an invalid or
//     non-intersecting slot altogether.
//
// This is the simple version that is right first: no shared-memory staging,
// no vector loads.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void frontier_narrow_kernel(
    const float* __restrict__ q_rects,     // (M, 4)
    const int32_t* __restrict__ q_bits,    // (M, Wp)
    const int16_t* __restrict__ f_codes,   // (M, F, 4)
    const int32_t* __restrict__ f_bm,      // (M, F, Wp)
    const int8_t* __restrict__ f_valid,    // (M, F)
    const float* __restrict__ dict_x,      // (Dx,)
    const float* __restrict__ dict_y,      // (Dy,)
    int8_t* __restrict__ out,              // (M, F)
    int M, int F, int Wp, int Dx, int Dy) {
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (int64_t)M * F) return;
  const int64_t m = slot / F;
  int8_t hit = 0;
  if (__ldg(f_valid + slot) > 0) {
    const float4 b = wisk::dequantize_mbr(f_codes + slot * 4, dict_x, dict_y, Dx, Dy);
    if (wisk::rect_meets(q_rects + m * 4, b)) {
      hit = wisk::words_hit_thread(f_bm + slot * Wp, q_bits + m * Wp, Wp);
    }
  }
  out[slot] = hit;
}

__global__ void frontier_filter_kernel(
    const float* __restrict__ q_rects,     // (M, 4)
    const int32_t* __restrict__ q_bm,      // (M, W)
    const float* __restrict__ f_mbrs,      // (M, F, 4)
    const int32_t* __restrict__ f_bm,      // (M, F, W)
    const int8_t* __restrict__ f_valid,    // (M, F)
    int8_t* __restrict__ out,              // (M, F)
    int M, int F, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= (int64_t)M * F) return;  // warp-uniform: the whole warp leaves
  const int64_t m = slot / F;
  bool hit = false;
  if (__ldg(f_valid + slot) > 0) {
    const float4 b = wisk::load_mbr(f_mbrs + slot * 4);
    if (wisk::rect_meets(q_rects + m * 4, b)) {
      hit = wisk::words_hit_warp(f_bm + slot * W, q_bm + m * W, W, lane);
    }
  }
  if (lane == 0) out[slot] = hit ? 1 : 0;
}

unsigned grid_for(int64_t n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_frontier_narrow(const void* q_rects, const void* q_bits,
                         const void* f_codes, const void* f_bm,
                         const void* f_valid, const void* dict_x,
                         const void* dict_y, void* out, int M, int F, int Wp,
                         int Dx, int Dy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * F;
  if (n > 0) {
    frontier_narrow_kernel<<<grid_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)q_rects, (const int32_t*)q_bits,
        (const int16_t*)f_codes, (const int32_t*)f_bm,
        (const int8_t*)f_valid, (const float*)dict_x, (const float*)dict_y,
        (int8_t*)out, M, F, Wp, Dx, Dy);
  }
  return (int)cudaGetLastError();
}

int wisk_frontier_filter(const void* q_rects, const void* q_bm,
                         const void* f_mbrs, const void* f_bm,
                         const void* f_valid, void* out, int M, int F, int W,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * F;
  if (n > 0) {
    frontier_filter_kernel<<<grid_for(n, kWarpsPerBlock), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)q_rects, (const int32_t*)q_bm, (const float*)f_mbrs,
        (const int32_t*)f_bm, (const int8_t*)f_valid, (int8_t*)out, M, F, W);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
