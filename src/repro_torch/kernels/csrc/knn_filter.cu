// Boolean-kNN frontier distance filters for Hopper (sm_90a).
//
// Replaces two TPU kernels (rows 7 and 8 of the port's kernel table) with
// one kernel in two instances that gather for themselves:
//   src/repro/kernels/knn_filter.py::knn_filter_narrow -> wisk_knn_level_dist_narrow
//     (the level's int16 MBR rank codes and coordinate dictionaries: the
//     default descent);
//   src/repro/kernels/knn_filter.py::knn_filter        -> wisk_knn_level_dist
//     (the level's f32 MBRs: quantized=False, a snapshot without narrow
//     planes, or a live delta's widened level arrays).
// Oracles: kernels/ref.py knn_level_dist_narrow_ref / knn_level_dist_ref,
// which equal knn_filter_narrow_ref / knn_filter_ref on the planes gathered
// at the frontier.
//
// For each (query point m, frontier slot f), out = the squared min-distance
// from the point to the closed MBR of node frontier[m, f], or +inf where the
// slot is empty (id -1) or none of the node's bitmap words ANDs non-zero
// with the query's. Output (M, F) f32.
//
// Exactness: dx*dx + dy*dy is computed with __fmul_rn / __fadd_rn, which
// nvcc never contracts into a fused multiply-add (it does by default for
// a*a + b*b under -O3), so the distances equal the plain PyTorch version
// and the host oracle core/query.py _mbr_dist2_f32 bit for bit. The narrow
// MBR decodes through the dictionaries exactly, so both instances give the
// same bits on the same level.
//
// What bounds it on the H100: bytes. Per slot about ten flops against an
// MBR (16 bytes, or 8 bytes of codes and four dictionary entries) and the
// node words. The TPU kernels take planes gathered at the frontier; at the
// leaf level of a 1024-query batch (F = 8192) the engine's gather wrote and
// the kernel read again an (M, F, Wp) int32 word plane and an (M, F, 4)
// int16 code plane (268 MB and 67 MB at Wp = 8, most slots padding), or an
// (M, F, W) plane at full width (8.6 GB). Here the kernel takes the level
// arrays and the int32 frontier, so no plane is made:
//   - one thread per (query, slot), blocks of consecutive slots of one
//     query sized to F, so neighbouring threads read neighbouring frontier
//     ids and write neighbouring distances (coalesced);
//   - the block stages query m's packed words (ops.pack_query_words) in
//     shared memory; a padding slot reads only its id; a node's words are
//     read only at the packed ids (no other word can hit), their loads
//     issued together (wisk::pairs_hit), and its MBR only after a hit;
//   - node ids clamp to [0, N-1] and codes to the dictionaries, as the
//     engine's gather and dequantize_mbr do.
// What is left is the (M, F) ids in and distances out, and the scattered
// word, code and dictionary reads of valid slots: each a 32-byte sector
// where the bound counts 4 or 8 bytes.
//
// The dictionaries are read through the read-only cache, not staged in
// shared memory: at the leaf level they hold up to 2 x 32,767 f32 (256 KB,
// more than a block may hold), and a block of 256 slots decodes at most 256
// MBRs (1,024 entries), so staging would read more than it saves.
//
// This is the simple version that is right first: no vector loads, and the
// scattered reads go one sector each through L1/L2.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;

struct Level {
  const float* q_pts;     // (M, 2)
  const int32_t* q_wids;  // (M, Wp) packed word ids
  const int32_t* q_bits;  // (M, Wp) packed word values
  const float* mbrs;      // (N, 4) f32 MBRs (wisk_knn_level_dist)
  const int16_t* codes;   // (N, 4) int16 rank codes (wisk_knn_level_dist_narrow)
  const float* dict_x;    // (Dx,) the level's sorted x coordinates (narrow)
  const float* dict_y;    // (Dy,)
  const int32_t* bms;     // (N, W) node bitmaps
  const int32_t* frontier;  // (M, F), -1 = empty slot
  float* out;             // (M, F)
  int F, Wp, N, W, Dx, Dy, chunks;
};

// One thread per (query m, frontier slot f), `chunks` blocks per query.
template <bool kNarrow>
__global__ void knn_level_kernel(Level L) {
  extern __shared__ int32_t s_words[];  // word ids (Wp), then values (Wp)
  int32_t* s_wid = s_words;
  int32_t* s_bit = s_words + L.Wp;
  const int64_t m = blockIdx.x / L.chunks;
  const int f = (int)(blockIdx.x % L.chunks) * blockDim.x + threadIdx.x;
  wisk::stage_packed_words(s_wid, s_bit, L.q_wids + m * L.Wp, L.q_bits + m * L.Wp, L.Wp, L.W);
  __syncthreads();
  if (f >= L.F) return;
  const int64_t slot = m * L.F + f;
  const int32_t id = __ldg(L.frontier + slot);
  float d = INFINITY;
  if (id >= 0) {
    const int64_t node = min(id, L.N - 1);  // dirty ids clamp like the gather
    if (wisk::pairs_hit(L.bms + node * L.W, s_wid, s_bit, L.Wp)) {
      const float4 b = kNarrow
          ? wisk::dequantize_mbr(L.codes + node * 4, L.dict_x, L.dict_y, L.Dx, L.Dy)
          : wisk::load_mbr(L.mbrs + node * 4);
      d = wisk::mbr_dist2(__ldg(L.q_pts + m * 2), __ldg(L.q_pts + m * 2 + 1), b);
    }
  }
  L.out[slot] = d;
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
    const size_t smem = 2 * (size_t)L.Wp * sizeof(int32_t);
    knn_level_kernel<kNarrow><<<(unsigned)((int64_t)M * L.chunks), threads, smem,
                                (cudaStream_t)stream>>>(L);
  }
  return (int)cudaGetLastError();
}

Level make_level(const void* q_pts, const void* q_wids, const void* q_bits,
                 const void* level_bms, const void* frontier, void* out, int F, int Wp,
                 int N, int W) {
  Level L = {};
  L.q_pts = (const float*)q_pts;
  L.q_wids = (const int32_t*)q_wids;
  L.q_bits = (const int32_t*)q_bits;
  L.bms = (const int32_t*)level_bms;
  L.frontier = (const int32_t*)frontier;
  L.out = (float*)out;
  L.F = F;
  L.Wp = Wp;
  L.N = N;
  L.W = W;
  return L;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_knn_level_dist(const void* q_pts, const void* q_wids, const void* q_bits,
                        const void* level_mbrs, const void* level_bms,
                        const void* frontier, void* out, int M, int F, int Wp,
                        int N, int W, int device, void* stream) {
  Level L = make_level(q_pts, q_wids, q_bits, level_bms, frontier, out, F, Wp, N, W);
  L.mbrs = (const float*)level_mbrs;
  return launch<false>(L, M, device, stream);
}

int wisk_knn_level_dist_narrow(const void* q_pts, const void* q_wids,
                               const void* q_bits, const void* level_codes,
                               const void* level_bms, const void* frontier,
                               const void* dict_x, const void* dict_y, void* out,
                               int M, int F, int Wp, int N, int W, int Dx, int Dy,
                               int device, void* stream) {
  Level L = make_level(q_pts, q_wids, q_bits, level_bms, frontier, out, F, Wp, N, W);
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
