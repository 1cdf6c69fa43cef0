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
// What bounds it on the H100: bytes. The (M, K) flags are written once and
// every rectangle and MBR read once; node words are needed only where a
// rectangle meets, and there only at the query's nonzero words (about 5 of
// 256 at 5 keywords: no other word can hit). The design keeps every other
// read off the card's memory, and the chain of dependent memory round
// trips short:
//   - a block takes kWarps = 8 queries (one warp each) against a strip of
//     kStrip = 512 consecutive nodes; the strip's MBRs are staged in shared
//     memory once per block by coalesced 16-byte loads, in a padded
//     transposed layout so that neither the staging nor the lanes' reads
//     conflict on banks;
//   - lane l owns the kRun = 16 consecutive nodes 16 l .. 16 l + 15 of the
//     strip: it tests their rectangles against the query's (in registers)
//     and writes their 16 flags with one 16-byte store, so a warp writes
//     512 consecutive bytes of its query's row;
//   - only a warp one of whose nodes meets its rectangle reads its query's
//     words: it compacts them into (word id, value) pairs in its own slice
//     of shared memory (wisk::warp_compact_words: ballots, no block-wide
//     step), at most kPairs at a time (a query with more nonzero words
//     takes more rounds, so W is not capped). At the leaf level most warps
//     read no query word at all;
//   - the meeting nodes are listed in the warp's slice and dealt out one
//     per lane, so that a query meeting a run of neighbouring nodes (one
//     lane's, on an STR level) tests them in parallel; each reads its
//     words at the pairs alone, their loads issued together
//     (wisk::pairs_hit), and sets its bit in the warp's hit mask.
// The output rows have a pitch Kp = K rounded up to 16 (so every run's
// store is 16-byte aligned; flags past K are 0), and the wrapper returns
// the (M, K) view. The query tile is one constant for every level: a tile
// picked per launch to spread the small levels (K = 4, 19) over more SMs
// was no faster at any level than 8 queries a block.
//
// This is the simple version that is right first: no TMA, no clusters.
#include "slot_predicates.cuh"

namespace {

constexpr int kRun = 16;                   // nodes per lane: one 16-byte store of flags
constexpr int kStrip = 32 * kRun;          // nodes per block
constexpr int kPitch = kStrip / kRun + 1;  // staged MBRs: kRun rows of 33 (padded)
constexpr int kPairs = 64;                 // query words a warp holds per round
constexpr int kWarps = 8;                  // queries per block, a warp each

// Four 0/1 flags (bits 0-3 of b) as the four bytes of a word, first flag
// in the lowest byte.
__device__ __forceinline__ uint32_t flag_bytes(unsigned b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// A warp's slice of shared memory.
struct WarpSlice {
  int32_t wid[kPairs];      // the query's nonzero words of this round: ids
  int32_t bit[kPairs];      // and values
  uint16_t list[kStrip];    // the strip's nodes that meet the query's rectangle
  uint32_t hit[kStrip / 32];  // their keyword hits, a bit per node of the strip
};

__global__ void __launch_bounds__(32 * kWarps)
    skr_filter_kernel(const float4* __restrict__ q_rects,  // (M, 4)
                      const int32_t* __restrict__ q_bm,    // (M, W)
                      const float4* __restrict__ n_mbrs,   // (K, 4)
                      const int32_t* __restrict__ n_bm,    // (K, W)
                      int8_t* __restrict__ out,            // (M, Kp)
                      int M, int K, int Kp, int W) {
  extern __shared__ float4 s_mem[];
  float4* s_mbr = s_mem;  // node i of the strip at [(i % kRun) * kPitch + i / kRun]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  WarpSlice& ws = reinterpret_cast<WarpSlice*>(s_mem + kRun * kPitch)[warp];
  const int64_t k0 = (int64_t)blockIdx.y * kStrip;
  const int n_nodes = (int)min((int64_t)kStrip, (int64_t)K - k0);
  const int64_t m = (int64_t)blockIdx.x * kWarps + warp;
  // the query's rectangle loads while the strip is staged
  const float4 q = m < M ? __ldg(q_rects + m) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    s_mbr[(i % kRun) * kPitch + i / kRun] = __ldg(n_mbrs + k0 + i);
  }
  __syncthreads();  // the only block-wide step: a warp past M may leave after it
  if (m >= M) return;
  unsigned meet = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (lane * kRun + j < n_nodes && wisk::rect_meets(q, s_mbr[j * kPitch + lane])) {
      meet |= 1u << j;
    }
  }
  // list the meeting nodes: lane l's after those of the lanes before it
  const int mine = __popc(meet);
  int at = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, at, d);
    if (lane >= d) at += v;
  }
  const int total = __shfl_sync(0xffffffffu, at, 31);
  unsigned hit = 0;
  if (total > 0) {  // warp-uniform
    at -= mine;
    for (unsigned t = meet; t != 0; t &= t - 1) ws.list[at++] = lane * kRun + __ffs(t) - 1;
    if (lane < kStrip / 32) ws.hit[lane] = 0;
    const int32_t* qw = q_bm + m * W;
    for (int w0 = 0; w0 < W;) {  // warp-uniform: a round per kPairs nonzero words
      int32_t fold;
      int resume;
      // syncs the warp at its end: the list and the cleared mask are seen too
      const int n = min(wisk::warp_compact_words(ws.wid, ws.bit, qw, w0, W - w0, kPairs, &fold,
                                                 &resume),
                        kPairs);
      for (int i = lane; i < total; i += 32) {
        const int node = ws.list[i];
        const uint32_t bit = 1u << (node & 31);
        if (!(ws.hit[node >> 5] & bit) &&
            wisk::pairs_hit(n_bm + (k0 + node) * W, ws.wid, ws.bit, n)) {
          atomicOr(&ws.hit[node >> 5], bit);
        }
      }
      __syncwarp();  // this round's pairs are read and its hits set
      w0 = resume;
    }
    hit = (ws.hit[lane >> 1] >> ((lane & 1) * kRun)) & 0xffffu;
  }
  const int64_t node0 = k0 + lane * kRun;
  if (node0 < Kp) {
    const uint4 flags = make_uint4(flag_bytes(hit), flag_bytes(hit >> 4), flag_bytes(hit >> 8),
                                   flag_bytes(hit >> 12));
    *reinterpret_cast<uint4*>(out + m * Kp + node0) = flags;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0. `out`
// has row pitch Kp (K rounded up to a multiple of 16) and is 16-byte
// aligned. Shared memory is 8,448 B of staged MBRs plus a 1,600 B slice per
// warp, 21,248 B in all.
int wisk_skr_filter(const void* q_rects, const void* q_bm, const void* n_mbrs,
                    const void* n_bm, void* out, int M, int K, int Kp, int W, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Kp % kRun != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  if (M > 0 && K > 0) {
    const dim3 grid((unsigned)((M + kWarps - 1) / kWarps), (unsigned)((K + kStrip - 1) / kStrip));
    const size_t smem = kRun * kPitch * sizeof(float4) + kWarps * sizeof(WarpSlice);
    skr_filter_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const float4*)q_rects, (const int32_t*)q_bm, (const float4*)n_mbrs,
        (const int32_t*)n_bm, (int8_t*)out, M, K, Kp, W);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
