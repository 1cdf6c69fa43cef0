// Frontier filter on the bandwidth-lean planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/frontier.py::frontier_filter_narrow
// (row 1 of the port's kernel table). Oracle: kernels/ref.py
// frontier_filter_narrow_ref in this package.
//
// For each (query m, frontier slot f): dequantize the slot's four int16 MBR
// rank codes through the level's sorted f32 coordinate dictionaries, test the
// closed-rectangle intersection with the query, AND the slot's Wp packed
// bitmap words with the query's packed words (any nonzero word is a keyword
// hit), AND the slot's validity flag. Output (M, F) int8.
//
// What bounds it on the H100: bytes. Per slot it reads 8 bytes of codes,
// 4*Wp bytes of word planes and 1 byte of validity, gathers four dictionary
// entries, and does a handful of compares: far below one operation per byte
// at the card's rate, so the time is the (M, F, Wp) word plane and the codes
// streaming in from HBM/L2. The dictionaries (up to 32767 f32 each, ~128 KiB,
// so the two together can overflow the 227 KB of shared memory) stay in
// global memory and are read through the read-only path (__ldg); they are
// small and hot, so they live in L1/L2.
//
// This is the simple version that is right first: one thread per (query,
// slot), no shared-memory staging, no vector loads. The survivor matrix is
// bit-identical to the reference because the path only compares floats.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    const int16_t* c = f_codes + slot * 4;
    // codes come from the snapshot's encoder and are always in range; the
    // clamp only keeps a malformed code from reading out of bounds
    const int cx0 = min(max((int)__ldg(c + 0), 0), Dx - 1);
    const int cy0 = min(max((int)__ldg(c + 1), 0), Dy - 1);
    const int cx1 = min(max((int)__ldg(c + 2), 0), Dx - 1);
    const int cy1 = min(max((int)__ldg(c + 3), 0), Dy - 1);
    const float xlo = __ldg(dict_x + cx0);
    const float ylo = __ldg(dict_y + cy0);
    const float xhi = __ldg(dict_x + cx1);
    const float yhi = __ldg(dict_y + cy1);
    const float* q = q_rects + m * 4;
    const bool inter = (__ldg(q + 0) <= xhi) && (xlo <= __ldg(q + 2)) &&
                       (__ldg(q + 1) <= yhi) && (ylo <= __ldg(q + 3));
    if (inter) {
      const int32_t* fb = f_bm + slot * Wp;
      const int32_t* qb = q_bits + m * Wp;
      for (int p = 0; p < Wp; ++p) {
        if ((__ldg(fb + p) & __ldg(qb + p)) != 0) {
          hit = 1;
          break;
        }
      }
    }
  }
  out[slot] = hit;
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0.
int wisk_frontier_narrow(const void* q_rects, const void* q_bits,
                         const void* f_codes, const void* f_bm,
                         const void* f_valid, const void* dict_x,
                         const void* dict_y, void* out, int M, int F, int Wp,
                         int Dx, int Dy, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)M * F;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    frontier_narrow_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)q_rects, (const int32_t*)q_bits,
        (const int16_t*)f_codes, (const int32_t*)f_bm,
        (const int8_t*)f_valid, (const float*)dict_x, (const float*)dict_y,
        (int8_t*)out, M, F, Wp, Dx, Dy);
  }
  return (int)cudaGetLastError();
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
