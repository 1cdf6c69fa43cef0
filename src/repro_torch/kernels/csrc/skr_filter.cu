// Dense SKR node filter for Hopper (sm_90a): the relevance matrix of the
// dense A/B scan (``retrieve(mode="dense")``), every query against every
// node of one level.
//
// Replaces the TPU kernel src/repro/kernels/skr_filter.py::skr_filter (row
// 12 of the port's kernel table). Oracle: kernels/ref.py skr_filter_ref.
//
// Output (M, K) int8: the query rectangle meets the node's MBR (closed) and
// one of the node's W words ANDs non-zero with the query's. Only compares
// and integer ANDs, so the output is bit-identical to the reference.
//
// Layout: one thread per (query, node) pair. A block is a tile of
// kQueries queries (threadIdx.y) by 32 nodes (threadIdx.x) and walks a strip
// of kNodesPerBlock nodes, so neighbouring lanes read neighbouring MBRs
// (coalesced 16-byte rows) and write neighbouring output bytes. The tile's
// query words are staged in shared memory once per block. The rectangle test
// comes first: a pair whose rectangle misses reads no word, and the word
// loop stops at the first hit. M, K and W are taken as they are (no padding
// to a tile); the edges are masked.
//
// What bounds it on the H100: bytes. The (M, K) output and the MBR planes are
// read or written once; node words are read only for pairs whose rectangles
// meet, until the first hit (at the leaf level most pairs miss). Lanes that
// pass the rectangle test read words of different nodes, W words apart: that
// gather is uncoalesced, acceptable while few pairs pass.
//
// This is the simple version that is right first: no vector loads, no TMA.
#include "slot_predicates.cuh"

namespace {

constexpr int kQueries = 8;          // queries per block (threadIdx.y)
constexpr int kNodesPerBlock = 256;  // nodes per block, 32 at a time

__global__ void skr_filter_kernel(const float* __restrict__ q_rects,   // (M, 4)
                                  const int32_t* __restrict__ q_bm,    // (M, W)
                                  const float* __restrict__ n_mbrs,    // (K, 4)
                                  const int32_t* __restrict__ n_bm,    // (K, W)
                                  int8_t* __restrict__ out,            // (M, K)
                                  int M, int K, int W) {
  extern __shared__ int32_t s_q[];  // (kQueries, W)
  const int64_t m0 = (int64_t)blockIdx.y * kQueries;
  const int n_q = (int)min((int64_t)kQueries, (int64_t)M - m0);
  for (int i = threadIdx.y * 32 + threadIdx.x; i < n_q * W; i += 32 * kQueries) {
    s_q[i] = __ldg(q_bm + m0 * W + i);
  }
  __syncthreads();
  if ((int)threadIdx.y >= n_q) return;
  const int64_t m = m0 + threadIdx.y;
  const float* q = q_rects + m * 4;
  const int32_t* qw = s_q + threadIdx.y * W;
  const int64_t k_end = min((int64_t)K, (int64_t)(blockIdx.x + 1) * kNodesPerBlock);
  for (int64_t k = (int64_t)blockIdx.x * kNodesPerBlock + threadIdx.x; k < k_end; k += 32) {
    bool hit = false;
    if (wisk::rect_meets(q, wisk::load_mbr(n_mbrs + k * 4))) {
      const int32_t* nb = n_bm + k * W;
      for (int w = 0; w < W; ++w) {
        if ((__ldg(nb + w) & qw[w]) != 0) {
          hit = true;
          break;
        }
      }
    }
    out[m * K + k] = hit ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0. The
// wrapper keeps kQueries * W at or below 8192 words, so the staged query
// tile (32 KiB) stays inside the default 48 KB of dynamic shared memory.
int wisk_skr_filter(const void* q_rects, const void* q_bm, const void* n_mbrs,
                    const void* n_bm, void* out, int M, int K, int W, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && K > 0) {
    const dim3 grid((unsigned)((K + kNodesPerBlock - 1) / kNodesPerBlock),
                    (unsigned)((M + kQueries - 1) / kQueries));
    const dim3 block(32, kQueries);
    const size_t smem = (size_t)kQueries * W * sizeof(int32_t);
    skr_filter_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float*)q_rects, (const int32_t*)q_bm, (const float*)n_mbrs,
        (const int32_t*)n_bm, (int8_t*)out, M, K, W);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
