// Unfused candidate verification for Hopper (sm_90a): the Eq. 1 ``w2``
// stage on candidates already gathered into (M, C) planes.
//
// Replaces two TPU kernels (rows 9 and 10 of the port's kernel table):
//   src/repro/kernels/skr_verify.py::skr_verify         -> wisk_skr_verify
//     (all W bitmap words: a live delta's insert slots once one buffered
//     term falls outside its leaf's dictionary, and fused=False at full
//     width, where base candidates and insert slots go through in one call);
//   src/repro/kernels/skr_verify.py::skr_verify_compact -> wisk_skr_verify_compact
//     (leaf-local compact words: the insert slots while every buffered term
//     lies in its leaf's dictionary, and fused=False on the compact bank).
// Oracles: kernels/ref.py skr_verify_ref / skr_verify_compact_ref.
//
// Output (M, C) int8: the candidate lies in the closed query rectangle, one
// of its words ANDs non-zero with the query's, and it is valid. Only floats
// are compared, so the output is bit-identical to the reference.
//   - Full width: one warp per candidate. The block serves a run of one
//     query's candidates, so it stages that query's W words (1 KiB at the osm
//     profile) in shared memory once. An invalid candidate, or one outside
//     the rectangle, reads no word: the output is inr & kw & valid, so that
//     is exact. Lanes read neighbouring words (coalesced 128-byte rows) and
//     the warp stops at the first 32-word stride that holds a hit.
//   - Compact: one thread per candidate. Candidates are leaf-slot-major, T
//     slots of OBJ each (for the delta's insert slots OBJ is slots_per_leaf),
//     and candidate c pairs with the query words of slot c / OBJ. The
//     one-word signature test comes before the Wl-word loop; it is implied
//     by the word test, so it cannot change the output.
//
// What bounds them on the H100: bytes. Per candidate a few compares against
// 9 bytes of coordinates and flag, then the words that decide the keyword
// test; the full-width plane is the largest operand (4.3 GB at M = 1024,
// C = 4096, W = 256, the unfused A/B baseline).
//
// This is the simple version that is right first: no vector loads, no TMA.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kCandsPerBlock = 16 * kWarpsPerBlock;

__global__ void skr_verify_kernel(
    const float* __restrict__ q_rects,     // (M, 4)
    const int32_t* __restrict__ q_bm,      // (M, W)
    const float* __restrict__ cand_x,      // (M, C)
    const float* __restrict__ cand_y,      // (M, C)
    const int32_t* __restrict__ cand_bm,   // (M, C, W)
    const int8_t* __restrict__ cand_valid, // (M, C)
    int8_t* __restrict__ out,              // (M, C)
    int C, int W, int chunks) {
  extern __shared__ int32_t s_q[];
  const int64_t m = blockIdx.x / chunks;
  const int64_t c0 = (int64_t)(blockIdx.x % chunks) * kCandsPerBlock;
  wisk::stage_words(s_q, q_bm + m * W, W);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float* q = q_rects + m * 4;
  const int64_t c_end = min((int64_t)C, c0 + kCandsPerBlock);
  // c depends on the warp only, so every branch below is warp-uniform
  for (int64_t c = c0 + (threadIdx.x >> 5); c < c_end; c += kWarpsPerBlock) {
    const int64_t cand = m * C + c;
    bool hit = false;
    if (__ldg(cand_valid + cand) > 0 &&
        wisk::point_in_rect(q, __ldg(cand_x + cand), __ldg(cand_y + cand))) {
      hit = wisk::words_hit_warp(cand_bm + cand * W, s_q, W, lane);
    }
    if (lane == 0) out[cand] = hit ? 1 : 0;
  }
}

__global__ void skr_verify_compact_kernel(
    const float* __restrict__ q_rects,     // (M, 4)
    const int32_t* __restrict__ q_cbm,     // (M, T, Wl)
    const int32_t* __restrict__ q_sig,     // (M, T)
    const float* __restrict__ cand_x,      // (M, T * OBJ)
    const float* __restrict__ cand_y,      // (M, T * OBJ)
    const int32_t* __restrict__ cand_cbm,  // (M, T * OBJ, Wl)
    const int32_t* __restrict__ cand_sig,  // (M, T * OBJ)
    const int8_t* __restrict__ cand_valid, // (M, T * OBJ)
    int8_t* __restrict__ out,              // (M, T * OBJ)
    int M, int T, int OBJ, int Wl) {
  const int64_t C = (int64_t)T * OBJ;
  const int64_t cand = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cand >= (int64_t)M * C) return;
  const int64_t m = cand / C;
  const int64_t pair = m * T + (cand - m * C) / OBJ;  // (query, leaf slot)
  int8_t hit = 0;
  if (__ldg(cand_valid + cand) > 0 && (__ldg(cand_sig + cand) & __ldg(q_sig + pair)) != 0 &&
      wisk::point_in_rect(q_rects + m * 4, __ldg(cand_x + cand), __ldg(cand_y + cand))) {
    hit = wisk::words_hit_thread(cand_cbm + cand * Wl, q_cbm + pair * Wl, Wl) ? 1 : 0;
  }
  out[cand] = hit;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
// The wrapper keeps W at or below 8192 words, so the staged query (32 KiB)
// stays inside the default 48 KB of dynamic shared memory.
int wisk_skr_verify(const void* q_rects, const void* q_bm, const void* cand_x,
                    const void* cand_y, const void* cand_bm,
                    const void* cand_valid, void* out, int M, int C, int W,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && C > 0) {
    const int chunks = (C + kCandsPerBlock - 1) / kCandsPerBlock;
    const size_t smem = (size_t)W * sizeof(int32_t);
    skr_verify_kernel<<<(unsigned)((int64_t)M * chunks), kThreads, smem,
                        (cudaStream_t)stream>>>(
        (const float*)q_rects, (const int32_t*)q_bm, (const float*)cand_x,
        (const float*)cand_y, (const int32_t*)cand_bm, (const int8_t*)cand_valid,
        (int8_t*)out, C, W, chunks);
  }
  return (int)cudaGetLastError();
}

int wisk_skr_verify_compact(const void* q_rects, const void* q_cbm,
                            const void* q_sig, const void* cand_x,
                            const void* cand_y, const void* cand_cbm,
                            const void* cand_sig, const void* cand_valid,
                            void* out, int M, int T, int OBJ, int Wl,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * T * OBJ;
  if (n > 0) {
    skr_verify_compact_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)q_rects, (const int32_t*)q_cbm, (const int32_t*)q_sig,
        (const float*)cand_x, (const float*)cand_y, (const int32_t*)cand_cbm,
        (const int32_t*)cand_sig, (const int8_t*)cand_valid, (int8_t*)out, M, T,
        OBJ, Wl);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
