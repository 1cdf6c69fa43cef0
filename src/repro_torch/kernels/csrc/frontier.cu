// Frontier filters for Hopper (sm_90a): the range descent's per-level
// survivor test, one kernel body in two instances that read the level
// arrays at the frontier themselves.
//
// Replaces two TPU kernels (rows 1 and 4 of the port's kernel table):
//   src/repro/kernels/frontier.py::frontier_filter_narrow -> wisk_frontier_level_narrow
//     (the level's int16 MBR rank codes and coordinate dictionaries: the
//     default descent);
//   src/repro/kernels/frontier.py::frontier_filter        -> wisk_frontier_level
//     (the level's f32 MBRs: quantized=False, a snapshot whose coordinate
//     dictionaries overflowed int16 and carries no narrow planes, or a live
//     delta's widened level arrays).
// Oracles: kernels/ref.py frontier_level_narrow_ref / frontier_level_ref,
// which equal frontier_filter_narrow_ref / frontier_filter_ref on the
// planes gathered at the frontier.
//
// For each (query m, frontier slot f) the slot survives when it holds a
// node (id >= 0), the node's closed MBR meets the query's closed rectangle,
// and one of the node's bitmap words ANDs non-zero with the query's. Output
// (M, F) int8. Only floats are compared, so the survivors are bit-identical
// to the reference.
//
// What bounds them on the H100: bytes. Per slot four compares against 16
// bytes of MBR (or 8 bytes of codes and four dictionary entries) and a few
// ANDs: far below one operation per byte. The TPU kernels take planes the
// engine gathered at the frontier -- an (M, F, W) word plane on the f32
// descent (268 MB at M = 1024, F = 256, W = 256) or (M, F, Wp) words and
// (M, F, 4) codes on the narrow one -- which the engine wrote and the
// kernel read back. Here the kernel takes the level arrays, the int32
// frontier and the query's W bitmap words, so no plane is made:
//   - one thread per (query, slot), blocks of consecutive slots of one
//     query sized to F, so neighbouring threads read neighbouring frontier
//     ids and write neighbouring flags (coalesced);
//   - a padding slot reads only its id; a valid slot reads its MBR (or its
//     codes, decoded through the dictionaries); only where the MBR meets
//     the rectangle does it read the node's words;
//   - those words are read only at the query's nonzero words (no other
//     word can hit), which the block compacts into (word id, value) pairs
//     in shared memory (wisk::compact_words, in rounds of kRoundWords
//     words, so W is not capped), and their loads go out together
//     (wisk::pairs_hit); a block none of whose slots meets its rectangle
//     skips the compaction and reads no query word;
//   - node ids clamp to [0, N-1] and codes to the dictionaries, as the
//     engine's gather and dequantize_mbr do.
// What is left is the (M, F) ids in and flags out, and the scattered MBR,
// code, dictionary and word reads of valid slots: each a 32-byte sector
// where the bound counts 4 to 16 bytes.
//
// The dictionaries are read through the read-only cache, not staged in
// shared memory (see knn_filter.cu: up to 2 x 32,767 f32, more than a block
// may hold).
//
// This is the simple version that is right first: no vector loads, no
// tensor cores, no TMA.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;

struct Level {
  const float* q_rects;     // (M, 4)
  const int32_t* q_bm;      // (M, W) query bitmap words
  const float* mbrs;        // (N, 4) f32 MBRs (wisk_frontier_level)
  const int16_t* codes;     // (N, 4) int16 rank codes (wisk_frontier_level_narrow)
  const float* dict_x;      // (Dx,) the level's sorted x coordinates (narrow)
  const float* dict_y;      // (Dy,)
  const int32_t* bms;       // (N, W) node bitmaps
  const int32_t* frontier;  // (M, F), -1 = empty slot
  int8_t* out;              // (M, F)
  int F, N, W, Dx, Dy, chunks;
};

// One thread per (query m, frontier slot f), `chunks` blocks per query.
// Every thread of the block reaches the block-wide steps (the vote and the
// compaction), so a thread past F does not return early.
template <bool kNarrow>
__global__ void frontier_level_kernel(Level L) {
  extern __shared__ int32_t s_mem[];  // (round,) word ids, then (round,) values
  __shared__ int s_cnt[kThreads / 32];
  const int64_t m = blockIdx.x / L.chunks;
  const int f = (int)(blockIdx.x % L.chunks) * blockDim.x + threadIdx.x;
  const int64_t slot = m * L.F + f;
  int64_t node = 0;
  bool live = false;  // the slot holds a node whose MBR meets the rectangle
  if (f < L.F) {
    const int32_t id = __ldg(L.frontier + slot);
    if (id >= 0) {
      node = min(id, L.N - 1);  // dirty ids clamp like the gather
      const float4 b = kNarrow
          ? wisk::dequantize_mbr(L.codes + node * 4, L.dict_x, L.dict_y, L.Dx, L.Dy)
          : wisk::load_mbr(L.mbrs + node * 4);
      live = wisk::rect_meets(L.q_rects + m * 4, b);
    }
  }
  bool hit = false;
  if (__syncthreads_or(live)) {  // block-uniform
    const int round = min(L.W, wisk::kRoundWords);
    int32_t* s_wid = s_mem;
    int32_t* s_bit = s_mem + round;
    const int32_t* q = L.q_bm + m * L.W;
    for (int w0 = 0; w0 < L.W; w0 += wisk::kRoundWords) {
      if (w0 > 0) __syncthreads();  // the last round's pairs are read
      const int n = wisk::compact_words(s_wid, s_bit, s_cnt, q, w0,
                                        min(wisk::kRoundWords, L.W - w0));
      if (live && !hit) hit = wisk::pairs_hit(L.bms + node * L.W, s_wid, s_bit, n);
    }
  }
  if (f < L.F) L.out[slot] = hit ? 1 : 0;
}

// The block size follows F (a multiple of 32, at most kThreads), so the
// narrow frontiers near the root do not idle most of a block.
template <bool kNarrow>
int launch(Level L, int M, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)M * L.F > 0) {
    const int threads = L.F >= kThreads ? kThreads : ((L.F + 31) / 32) * 32;
    L.chunks = (L.F + threads - 1) / threads;
    const size_t smem = 2 * (size_t)min(L.W, wisk::kRoundWords) * sizeof(int32_t);
    frontier_level_kernel<kNarrow><<<(unsigned)((int64_t)M * L.chunks), threads, smem,
                                     (cudaStream_t)stream>>>(L);
  }
  return (int)cudaGetLastError();
}

Level make_level(const void* q_rects, const void* q_bm, const void* level_bms,
                 const void* frontier, void* out, int F, int N, int W) {
  Level L = {};
  L.q_rects = (const float*)q_rects;
  L.q_bm = (const int32_t*)q_bm;
  L.bms = (const int32_t*)level_bms;
  L.frontier = (const int32_t*)frontier;
  L.out = (int8_t*)out;
  L.F = F;
  L.N = N;
  L.W = W;
  return L;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_frontier_level(const void* q_rects, const void* q_bm, const void* level_mbrs,
                        const void* level_bms, const void* frontier, void* out, int M,
                        int F, int N, int W, int device, void* stream) {
  Level L = make_level(q_rects, q_bm, level_bms, frontier, out, F, N, W);
  L.mbrs = (const float*)level_mbrs;
  return launch<false>(L, M, device, stream);
}

int wisk_frontier_level_narrow(const void* q_rects, const void* q_bm,
                               const void* level_codes, const void* level_bms,
                               const void* frontier, const void* dict_x,
                               const void* dict_y, void* out, int M, int F, int N, int W,
                               int Dx, int Dy, int device, void* stream) {
  Level L = make_level(q_rects, q_bm, level_bms, frontier, out, F, N, W);
  L.codes = (const int16_t*)level_codes;
  L.dict_x = (const float*)dict_x;
  L.dict_y = (const float*)dict_y;
  L.Dx = Dx;
  L.Dy = Dy;
  return launch<true>(L, M, device, stream);
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
