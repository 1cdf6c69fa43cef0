// Standing-subscription matching for Hopper (sm_90a): every arriving object
// against every slot of the compiled subscription block.
//
// Replaces the TPU kernel src/repro/kernels/sub_match.py::sub_match (row 11
// of the port's kernel table). Oracles: kernels/ref.py sub_match_packed_ref
// (these operands) and sub_match_ref (full-width bitmaps).
//
// Output (N, S) int8: the object's point lies in the subscription's closed
// rectangle, the two one-word OR-fold signatures share a bit, and one of the
// object's packed nonzero words (ids o_wids, values o_bits, from
// ops.pack_query_words) ANDs non-zero with the subscription's word of the
// same id. Only compares and integer ANDs, so the output is bit-identical to
// the reference. Block padding is inert without a validity plane: an empty
// slot carries NEVER_RECT (contains no point) and signature 0.
//
// Layout: one thread per (object, subscription). The 256 threads of a block
// take 256 consecutive subscriptions (coalesced rectangle and signature
// loads, kept in registers; coalesced output bytes) and loop over a tile of
// `objs` objects whose points, signatures and packed words the block stages
// in shared memory. Per pair: the rectangle test, then the signature test,
// then the gather s_bm[s, wid] of the object's Wp words, stopping at the
// first hit. That gather reads the row-major (S, W) block, so neighbouring
// lanes read W words apart; it runs only for pairs that pass both tests.
// (The TPU kernel gathers from a word-major (W, BS) tile; a word-major copy
// of the block is later work.)
//
// What bounds it on the H100: bytes. The (N, S) int8 output is written once
// and the block's rectangles and signatures are read once; subscription
// words only where the rectangle and the signature pass.
//
// This is the simple version that is right first: no vector loads, no TMA.
#include "slot_predicates.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sub_match_kernel(const float* __restrict__ o_pts,     // (N, 2)
                                 const int32_t* __restrict__ o_wids,  // (N, Wp)
                                 const int32_t* __restrict__ o_bits,  // (N, Wp)
                                 const int32_t* __restrict__ o_sig,   // (N,)
                                 const float* __restrict__ s_rects,   // (S, 4)
                                 const int32_t* __restrict__ s_bm,    // (S, W)
                                 const int32_t* __restrict__ s_sig,   // (S,)
                                 int8_t* __restrict__ out,            // (N, S)
                                 int N, int S, int Wp, int W, int objs) {
  // per staged object: x, y, sig, then Wp word ids and Wp word values
  extern __shared__ int32_t s_obj[];
  const int stride = 3 + 2 * Wp;
  const int64_t n0 = (int64_t)blockIdx.y * objs;
  const int n_obj = (int)min((int64_t)objs, (int64_t)N - n0);
  for (int i = threadIdx.x; i < n_obj * stride; i += kThreads) {
    const int64_t n = n0 + i / stride;
    const int f = i % stride;
    int32_t v;
    if (f < 2) {
      v = __float_as_int(__ldg(o_pts + n * 2 + f));
    } else if (f == 2) {
      v = __ldg(o_sig + n);
    } else if (f < 3 + Wp) {
      v = min(max(__ldg(o_wids + n * Wp + (f - 3)), 0), W - 1);  // clamp: never read out of the row
    } else {
      v = __ldg(o_bits + n * Wp + (f - 3 - Wp));
    }
    s_obj[i] = v;
  }
  __syncthreads();
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const float4 r = wisk::load_mbr(s_rects + s * 4);  // (xlo, ylo, xhi, yhi)
  const int32_t sig = __ldg(s_sig + s);
  const int32_t* row = s_bm + s * W;
  for (int j = 0; j < n_obj; ++j) {
    const int32_t* o = s_obj + j * stride;
    const float x = __int_as_float(o[0]);
    const float y = __int_as_float(o[1]);
    bool hit = false;
    if (x >= r.x && x <= r.z && y >= r.y && y <= r.w && (o[2] & sig) != 0) {
      for (int p = 0; p < Wp; ++p) {
        if ((__ldg(row + o[3 + p]) & o[3 + Wp + p]) != 0) {
          hit = true;
          break;
        }
      }
    }
    out[(n0 + j) * S + s] = hit ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0. The
// wrapper picks `objs` so that objs * (3 + 2 * Wp) ints stay at or below
// 8192 (32 KiB, inside the default 48 KB of dynamic shared memory).
int wisk_sub_match(const void* o_pts, const void* o_wids, const void* o_bits,
                   const void* o_sig, const void* s_rects, const void* s_bm,
                   const void* s_sig, void* out, int N, int S, int Wp, int W, int objs,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && S > 0) {
    const dim3 grid((unsigned)((S + kThreads - 1) / kThreads),
                    (unsigned)((N + objs - 1) / objs));
    const size_t smem = (size_t)objs * (3 + 2 * Wp) * sizeof(int32_t);
    sub_match_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)o_pts, (const int32_t*)o_wids, (const int32_t*)o_bits,
        (const int32_t*)o_sig, (const float*)s_rects, (const int32_t*)s_bm,
        (const int32_t*)s_sig, (int8_t*)out, N, S, Wp, W, objs);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
