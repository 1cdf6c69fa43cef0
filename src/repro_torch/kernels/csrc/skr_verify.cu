// Candidate verification on a slot bank for Hopper (sm_90a): the Eq. 1
// ``w2`` stage on a live delta's insert slots, read where they lie.
//
// Replaces two TPU kernels (rows 9 and 10 of the port's kernel table):
//   src/repro/kernels/skr_verify.py::skr_verify         -> wisk_skr_verify_slots
//     (all W bitmap words: a live delta's insert slots once one buffered
//     term falls outside its leaf's dictionary);
//   src/repro/kernels/skr_verify.py::skr_verify_compact -> wisk_skr_verify_slots_compact
//     (leaf-local compact words: the insert slots while every buffered term
//     lies in its leaf's dictionary).
// Oracles: kernels/ref.py skr_verify_slots_ref / skr_verify_slots_compact_ref.
//
// The TPU kernels verify candidates gathered into (M, C) planes first: for
// the insert slots of the selected leaves, (M, T*B) coordinates and ids and
// an (M, T*B, W) word plane (536,870,912 B at M = 1024, T = 32, B = 16,
// W = 256), over which the caller then recounted the keyword hits for
// Eq. 1's ``verified``. These kernels take the slot bank itself -- K leaves
// x B slots: the delta's per-leaf buffers ``ins_x``/``ins_y``/``ins_id``
// and ``ins_bm`` (or ``ins_cbm``/``ins_sig``) -- with the selected leaves
// ``top_leaf``/``leaf_ok`` (M, T), and return the per-query counts, so no
// plane is gathered and nothing is recounted. For slot b of leaf
// clamp(top_leaf[m, t], 0, K-1) (the reference's gather clamps the same):
//   valid = id >= 0 AND leaf_ok[m, t] > 0,
//   kw    = full width: any(bm[w] & q_bm[m, w]) over the W words;
//           compact: (sig & q_sig[m, t]) != 0 AND any(cbm[w] & q_cbm[m, t, w]),
//   inr   = the point lies in the closed query rectangle,
// and they write ids[m, t*B + b] = id if valid & kw & inr else -1,
// n_match[m] = sum(valid & kw & inr) and n_kw[m] = sum(valid & kw). n_kw
// counts keyword hits outside the rectangle too, so every valid slot takes
// its word test and the rectangle must not gate it: coordinates and the
// rectangle are read only after a keyword hit.
//
// The gathered entries (ops.verify_candidates*, the unfused A/B baseline)
// run the same kernels over an identity leaf map: the (M, C) planes as a
// bank of M rows of C slots (top_leaf[m, 0] = m), or on the compact words
// of M*T rows of OBJ slots (top_leaf[m, t] = m*T + t).
//
// Layout: one block per query. Its threads walk the query's T*B candidates
// in passes of the block's width, neighbouring threads on neighbouring
// slots of a leaf (ids, coordinates and outputs coalesced where the leaf's
// row is), and sum the two counts with warp shuffles and a shared sum,
// written once -- no atomics, no output to zero first.
//   - Full width: a pass votes (__syncthreads_or) whether any of its slots
//     is valid before it reads a query word; the first that has one
//     compacts the query's nonzero words into (word id, value) pairs in
//     shared memory (wisk::compact_words; rounds of kRoundWords words, so W
//     is not capped, and then every pass compacts again), and each valid
//     slot reads its row only at those ids, the loads of a group issued
//     together (wisk::pairs_hit); a hit stops after its group.
//   - Compact: one thread per slot reads the signature, then the Wl words.
//
// What bounds them on the H100: bytes. A delta holds a few buffered inserts
// per leaf, so most selected slots are empty: per slot the id, per valid
// slot a signature or the words at the query's nonzero ids (each a
// scattered 32-byte sector where the bound counts 4 bytes), per keyword hit
// 8 bytes of coordinates, and the (M, T*B) ids written out.
//
// This is the simple version that is right first: no vector loads, no TMA.
// The outputs are bit-identical to the reference: only floats are compared
// and the counts are integer sums.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
using wisk::kRoundWords;

struct Slots {
  const float* q_rects;     // (M, 4)
  const int32_t* q_words;   // full width: q_bm (M, W); compact: q_cbm (M, T, W)
  const int32_t* q_sig;     // compact: (M, T)
  const int32_t* top_leaf;  // (M, T)
  const int8_t* leaf_ok;    // (M, T)
  const float* x;           // (K, B)
  const float* y;           // (K, B)
  const int32_t* words;     // (K, B, W): full-width or compact words
  const int32_t* sig;       // compact: (K, B)
  const int32_t* id;        // (K, B), -1 = empty slot
  int32_t* ids;             // (M, T * B)
  int32_t* n_match;         // (M,)
  int32_t* n_kw;            // (M,)
  int T, K, B, W;           // W: the compact form's Wl
};

template <bool kCompact>
__global__ void slot_verify_kernel(Slots s) {
  extern __shared__ int32_t s_mem[];  // full width: (round,) word ids, then (round,) values
  __shared__ int s_cnt[kWarpsPerBlock];
  __shared__ int s_sum[2][kWarpsPerBlock];
  const int64_t m = blockIdx.x;
  const int C = s.T * s.B;
  const int round = min(s.W, kRoundWords);
  const int rounds = (s.W + kRoundWords - 1) / kRoundWords;
  int32_t* s_wid = s_mem;
  int32_t* s_bit = s_mem + round;
  int n = 0;            // pairs of the round in shared memory
  bool staged = false;  // the only round is in shared memory
  int n_match = 0, n_kw = 0;
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {  // block-uniform trip count
    const int c = c0 + threadIdx.x;
    int64_t pair = 0, slot = 0;
    int32_t id = -1;
    if (c < C) {
      const int t = c / s.B;
      pair = m * s.T + t;
      if (__ldg(s.leaf_ok + pair) > 0) {
        const int leaf = min(max(__ldg(s.top_leaf + pair), 0), s.K - 1);
        slot = (int64_t)leaf * s.B + (c - t * s.B);
        id = __ldg(s.id + slot);
      }
    }
    bool kw = false;
    if constexpr (kCompact) {
      kw = id >= 0 && (__ldg(s.sig + slot) & __ldg(s.q_sig + pair)) != 0 &&
           wisk::words_hit_thread(s.words + slot * s.W, s.q_words + pair * s.W, s.W);
    } else if (__syncthreads_or(id >= 0)) {  // no query word is read for a pass of empty slots
      for (int r = 0; r < rounds; ++r) {
        if (rounds > 1 || !staged) {
          if (r > 0) __syncthreads();  // every thread is done with the last round's pairs
          const int w0 = r * kRoundWords;
          n = wisk::compact_words(s_wid, s_bit, s_cnt, s.q_words + m * s.W, w0,
                                  min(kRoundWords, s.W - w0));
          staged = true;
        }
        if (id >= 0 && !kw) kw = wisk::pairs_hit(s.words + slot * s.W, s_wid, s_bit, n);
      }
    }
    int32_t out = -1;
    if (kw) {
      ++n_kw;
      if (wisk::point_in_rect(s.q_rects + m * 4, __ldg(s.x + slot), __ldg(s.y + slot))) {
        out = id;
        ++n_match;
      }
    }
    if (c < C) s.ids[m * C + c] = out;
  }
  for (int d = 16; d > 0; d >>= 1) {
    n_match += __shfl_down_sync(0xffffffffu, n_match, d);
    n_kw += __shfl_down_sync(0xffffffffu, n_kw, d);
  }
  if ((threadIdx.x & 31) == 0) {
    s_sum[0][threadIdx.x >> 5] = n_match;
    s_sum[1][threadIdx.x >> 5] = n_kw;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum_match = 0, sum_kw = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      sum_match += s_sum[0][w];
      sum_kw += s_sum[1][w];
    }
    s.n_match[m] = sum_match;
    s.n_kw[m] = sum_kw;
  }
}

// One block per query, as many threads as its T*B candidates need up to
// kThreads (a multiple of 32: compact_words and the shuffles take whole
// warps).
template <bool kCompact>
int launch(const Slots& s, int M, void* stream) {
  const int C = s.T * s.B;
  if (M > 0 && C > 0) {
    const int threads = C >= kThreads ? kThreads : ((C + 31) / 32) * 32;
    const size_t smem = kCompact ? 0 : 2 * (size_t)min(s.W, kRoundWords) * sizeof(int32_t);
    slot_verify_kernel<kCompact><<<(unsigned)M, threads, smem, (cudaStream_t)stream>>>(s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(); the Python wrapper raises on anything but 0.
// The full-width kernel takes at most 16 KiB of pairs in shared memory,
// whatever W is.
int wisk_skr_verify_slots(const void* q_rects, const void* q_bm, const void* top_leaf,
                          const void* leaf_ok, const void* x, const void* y,
                          const void* bm, const void* id, void* ids, void* n_match,
                          void* n_kw, int M, int T, int K, int B, int W, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Slots s{(const float*)q_rects, (const int32_t*)q_bm, nullptr,
                (const int32_t*)top_leaf, (const int8_t*)leaf_ok, (const float*)x,
                (const float*)y, (const int32_t*)bm, nullptr, (const int32_t*)id,
                (int32_t*)ids, (int32_t*)n_match, (int32_t*)n_kw, T, K, B, W};
  return launch<false>(s, M, stream);
}

int wisk_skr_verify_slots_compact(const void* q_rects, const void* q_cbm, const void* q_sig,
                                  const void* top_leaf, const void* leaf_ok, const void* x,
                                  const void* y, const void* cbm, const void* sig,
                                  const void* id, void* ids, void* n_match, void* n_kw, int M,
                                  int T, int K, int B, int Wl, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Slots s{(const float*)q_rects, (const int32_t*)q_cbm, (const int32_t*)q_sig,
                (const int32_t*)top_leaf, (const int8_t*)leaf_ok, (const float*)x,
                (const float*)y, (const int32_t*)cbm, (const int32_t*)sig, (const int32_t*)id,
                (int32_t*)ids, (int32_t*)n_match, (int32_t*)n_kw, T, K, B, Wl};
  return launch<true>(s, M, stream);
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
