// Fused forward pass of a bank of CDF MLPs for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cdf_mlp.py::cdf_mlp_bank (row 13
// of the port's kernel table). Oracle: kernels/ref.py cdf_mlp_ref.
//
// Each of the B models is 1 -> H -> H -> H -> 1 with ReLU between layers and
// a sigmoid head (weights w0 (B,1,H) b0 (B,H) w1 (B,H,H) b1 (B,H) w2 (B,H,H)
// b2 (B,H) w3 (B,H,1) b3 (B,1)), evaluated at N points; the output (N, B) f32
// is the only thing written. The hidden activations never leave registers.
//
// Layout: one thread per (point, model). A block stages the weights of
// kModels models (2H^2 + 5H + 1 floats each: 593 at H = 16) in shared memory
// and walks a strip of kPointsPerBlock points. Lane l of a warp takes model
// l % kModels, so neighbouring lanes read different models' weights at a
// stride of 2H^2 + 5H + 1 words -- an odd number, so those reads fall in
// distinct banks -- and write neighbouring output columns of one point row.
// Everything is f32 on the CUDA cores, with no tensor cores: TF32 would
// break the tolerance against the plain version (atol 2e-6 on outputs in
// [0, 1]). Products are summed in order with fused multiply-adds, where the
// plain version's einsum sums in its own order, so the two differ in the
// last bits; the first layer is x * w0 + b0 rounded step by step, as the
// plain version computes it.
//
// What bounds it on the H100: operations, 2 N B (H + 2H^2 + H) flops
// against the card's 67 TFLOP/s of f32; the bytes (x, the weights, the
// output) are far fewer. Each multiply-add reads its weight from shared
// memory, so the shared-memory load rate, not the FMA rate, limits this
// simple version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerBlock = 2048;

template <int H>
__host__ __device__ constexpr int params_per_model() {
  return 2 * H * H + 5 * H + 1;
}

template <int H, int kModels>
__global__ void cdf_mlp_kernel(const float* __restrict__ x,   // (N,)
                               const float* __restrict__ w0,  // (B, 1, H)
                               const float* __restrict__ b0,  // (B, H)
                               const float* __restrict__ w1,  // (B, H, H)
                               const float* __restrict__ b1,  // (B, H)
                               const float* __restrict__ w2,  // (B, H, H)
                               const float* __restrict__ b2,  // (B, H)
                               const float* __restrict__ w3,  // (B, H, 1)
                               const float* __restrict__ b3,  // (B, 1)
                               float* __restrict__ out,       // (N, B)
                               int N, int B) {
  constexpr int P = params_per_model<H>();
  // per staged model: w0[H] b0[H] w1[H*H] b1[H] w2[H*H] b2[H] w3[H] b3[1]
  constexpr int kW0 = 0, kB0 = H, kW1 = 2 * H, kB1 = kW1 + H * H, kW2 = kB1 + H,
                kB2 = kW2 + H * H, kW3 = kB2 + H, kB3 = kW3 + H;
  __shared__ float s_w[kModels * P];
  const int b0_model = blockIdx.x * kModels;
  const int n_models = min(kModels, B - b0_model);
  for (int i = threadIdx.x; i < n_models * P; i += kThreads) {
    const int mi = i / P;
    const int f = i % P;
    const int64_t b = b0_model + mi;
    float v;
    if (f < kB0) {
      v = __ldg(w0 + b * H + f);
    } else if (f < kW1) {
      v = __ldg(b0 + b * H + (f - kB0));
    } else if (f < kB1) {
      v = __ldg(w1 + b * H * H + (f - kW1));
    } else if (f < kW2) {
      v = __ldg(b1 + b * H + (f - kB1));
    } else if (f < kB2) {
      v = __ldg(w2 + b * H * H + (f - kW2));
    } else if (f < kW3) {
      v = __ldg(b2 + b * H + (f - kB2));
    } else if (f < kB3) {
      v = __ldg(w3 + b * H + (f - kW3));
    } else {
      v = __ldg(b3 + b);
    }
    s_w[i] = v;
  }
  __syncthreads();
  const int mi = threadIdx.x % kModels;
  if (mi >= n_models) return;
  const float* w = s_w + mi * P;
  const int64_t b = b0_model + mi;
  const int64_t n_end = min((int64_t)N, (int64_t)(blockIdx.y + 1) * kPointsPerBlock);
  for (int64_t n = (int64_t)blockIdx.y * kPointsPerBlock + threadIdx.x / kModels; n < n_end;
       n += kThreads / kModels) {
    const float xv = __ldg(x + n);
    float h[H], g[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      h[j] = fmaxf(__fadd_rn(__fmul_rn(xv, w[kW0 + j]), w[kB0 + j]), 0.f);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(h[i], w[kW1 + i * H + j], acc);
      g[j] = fmaxf(acc + w[kB1 + j], 0.f);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(g[i], w[kW2 + i * H + j], acc);
      h[j] = fmaxf(acc + w[kB2 + j], 0.f);
    }
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) o = fmaf(h[i], w[kW3 + i], o);
    o += w[kB3];
    out[n * B + b] = 1.f / (1.f + expf(-o));
  }
}

template <int H, int kModels>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* w3, const void* b3, void* out, int N,
           int B, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + kModels - 1) / kModels),
                  (unsigned)((N + kPointsPerBlock - 1) / kPointsPerBlock));
  cdf_mlp_kernel<H, kModels><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)w0, (const float*)b0, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2, (const float*)w3,
      (const float*)b3, (float*)out, N, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a hidden width without an
// instantiation; the Python wrapper raises on anything but 0 and admits
// only H in (4, 8, 16, 32). The staged weights stay under 48 KB of static
// shared memory: 16 models of H <= 16, or 4 of H = 32.
int wisk_cdf_mlp(const void* x, const void* w0, const void* b0, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* w3,
                 const void* b3, void* out, int N, int B, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 4: return launch<4, 16>(x, w0, b0, w1, b1, w2, b2, w3, b3, out, N, B, s);
    case 8: return launch<8, 16>(x, w0, b0, w1, b1, w2, b2, w3, b3, out, N, B, s);
    case 16: return launch<16, 16>(x, w0, b0, w1, b1, w2, b2, w3, b3, out, N, B, s);
    case 32: return launch<32, 4>(x, w0, b0, w1, b1, w2, b2, w3, b3, out, N, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
