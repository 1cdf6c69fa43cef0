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
// What bounds it on the H100: operations, 2 N B (H + 2H^2 + H) flops
// against the card's 67 TFLOP/s of f32; the bytes (x, the weights, the
// output) are far fewer. Everything is f32 on the CUDA cores, with no tensor
// cores: TF32 would break the tolerance against the plain version (atol 2e-6
// on outputs in [0, 1]). The FMA pipe issues one warp instruction a clock
// per scheduler, so every instruction that is not a multiply-add (a shared
// load, a ReLU, a bias add) takes a slot from the bound. The design keeps
// those few:
//
// * One warp per model. A block stages the weights of kModels = 8 models in
//   shared memory (2H^2 + 5H + 4 floats each, every segment 16-byte
//   aligned) and warp w evaluates model w, so all 32 lanes read the same
//   weight: every shared load is a broadcast, read as a float4 of four
//   consecutive outputs j of a row of w1 / w2 (row-major in (i, j)).
// * P points a thread (a template constant per H: 4 at H <= 8, 2 at H = 16,
//   1 at H = 32, so the 2 H P activations stay near 64 registers). One
//   float4 weight load then feeds 4 P fused multiply-adds.
// * Coalesced output. A warp's lanes hold one model's column, which in the
//   (N, B) plane lies at a stride of 4 B bytes. The block puts its (32 P
//   points x 8 models) tile through shared memory (two buffers, one barrier
//   a step) and stores each point's run of its 8 models contiguously.
//
// What still holds it above the bound (PERF.md, row 13): at H = 16 a
// (point, model) issues about 756 instructions (a count of the source)
// where the flops bound counts 544 fused multiply-adds: besides the 528
// FMAs, the float4 loads, the bias adds, the ReLUs, the first layer's
// separate rounding and the sigmoid. Variants with more blocks an SM, 4
// points a thread, 128-thread blocks or another loop order were no faster
// (tools/cdf_sweep.py). At H = 32 (one point a thread) a float4 load feeds
// only 4 multiply-adds.
//
// The arithmetic is the earlier one-thread-per-(point, model) kernel's,
// element by element: the first layer is x * w0 + b0 rounded step by step,
// as the plain version computes it; each hidden output is an fmaf chain
// over i = 0 .. H-1 with the bias added after it; the head is
// 1 / (1 + expf(-o)). The plain version's einsum sums in its own order, so
// the two differ in the last bits. ReLU is max.NaN.f32, which returns NaN
// when either operand is NaN, as jnp.maximum and torch.relu do (fmaxf would
// return 0): a NaN or infinite point gives NaN, as the reference does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModels = kThreads / 32;  // one warp per model
constexpr int kPointsPerBlock = 2048;   // ops._CDF_POINTS_PER_BLOCK
constexpr int kOutStride = kModels + 1;  // the output tile's row, padded off the banks

// max(v, 0) that returns NaN when v is NaN (jnp.maximum, torch.relu).
__device__ __forceinline__ float relu(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(0.f));
  return r;
}

// One staged model: w0[H] b0[H] w1[H*H] b1[H] w2[H*H] b2[H] w3[H] b3 and
// three floats of padding, so every segment starts on 16 bytes.
template <int H>
struct Layout {
  static_assert(H % 4 == 0, "the weights are read as float4");
  static constexpr int kW0 = 0, kB0 = H, kW1 = 2 * H, kB1 = kW1 + H * H, kW2 = kB1 + H,
                       kB2 = kW2 + H * H, kW3 = kB2 + H, kB3 = kW3 + H, kStride = kB3 + 4;
};

// Points a thread: 2 H P activations in registers, about 64.
template <int H>
__host__ __device__ constexpr int points_per_thread() {
  return H <= 8 ? 4 : H == 16 ? 2 : 1;
}

template <int H>
constexpr size_t shared_bytes() {
  return sizeof(float) * ((size_t)kModels * Layout<H>::kStride +
                          2 * (size_t)32 * points_per_thread<H>() * kOutStride);
}

// out[p][j] = relu(sum_i in[p][i] * wm[i][j] + bias[j]), the sum an fmaf
// chain over i in order, the bias added after it.
template <int H, int P>
__device__ __forceinline__ void hidden(const float4* wm, const float4* bias,
                                       const float (&in)[P][H], float (&out)[P][H]) {
#pragma unroll
  for (int jb = 0; jb < H / 4; ++jb) {
    float acc[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float4 w = wm[i * (H / 4) + jb];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[p][0] = fmaf(in[p][i], w.x, acc[p][0]);
        acc[p][1] = fmaf(in[p][i], w.y, acc[p][1]);
        acc[p][2] = fmaf(in[p][i], w.z, acc[p][2]);
        acc[p][3] = fmaf(in[p][i], w.w, acc[p][3]);
      }
    }
    const float4 b = bias[jb];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      out[p][4 * jb + 0] = relu(__fadd_rn(acc[p][0], b.x));
      out[p][4 * jb + 1] = relu(__fadd_rn(acc[p][1], b.y));
      out[p][4 * jb + 2] = relu(__fadd_rn(acc[p][2], b.z));
      out[p][4 * jb + 3] = relu(__fadd_rn(acc[p][3], b.w));
    }
  }
}

// The model whose weights start at w (shared, 16-byte aligned) at P points.
template <int H, int P>
__device__ __forceinline__ void evaluate(const float* w, const float (&x)[P], float (&y)[P]) {
  using L = Layout<H>;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float a[P][H], c[P][H];
#pragma unroll
  for (int jb = 0; jb < H / 4; ++jb) {
    const float4 w0 = w4[L::kW0 / 4 + jb];
    const float4 b0 = w4[L::kB0 / 4 + jb];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      a[p][4 * jb + 0] = relu(__fadd_rn(__fmul_rn(x[p], w0.x), b0.x));
      a[p][4 * jb + 1] = relu(__fadd_rn(__fmul_rn(x[p], w0.y), b0.y));
      a[p][4 * jb + 2] = relu(__fadd_rn(__fmul_rn(x[p], w0.z), b0.z));
      a[p][4 * jb + 3] = relu(__fadd_rn(__fmul_rn(x[p], w0.w), b0.w));
    }
  }
  hidden<H, P>(w4 + L::kW1 / 4, w4 + L::kB1 / 4, a, c);
  hidden<H, P>(w4 + L::kW2 / 4, w4 + L::kB2 / 4, c, a);
  float o[P];
#pragma unroll
  for (int p = 0; p < P; ++p) o[p] = 0.f;
#pragma unroll
  for (int jb = 0; jb < H / 4; ++jb) {
    const float4 w3 = w4[L::kW3 / 4 + jb];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      o[p] = fmaf(a[p][4 * jb + 0], w3.x, o[p]);
      o[p] = fmaf(a[p][4 * jb + 1], w3.y, o[p]);
      o[p] = fmaf(a[p][4 * jb + 2], w3.z, o[p]);
      o[p] = fmaf(a[p][4 * jb + 3], w3.w, o[p]);
    }
  }
  const float b3 = w[L::kB3];
#pragma unroll
  for (int p = 0; p < P; ++p) y[p] = 1.f / (1.f + expf(-__fadd_rn(o[p], b3)));
}

struct Bank {
  const float *w0, *b0, *w1, *b1, *w2, *b2, *w3, *b3;
};

// Grid (ceil(B / kModels), ceil(N / kPointsPerBlock)): a block takes
// kModels models and a strip of kPointsPerBlock points, in steps of 32 P.
template <int H>
__global__ void __launch_bounds__(kThreads, 2)
    cdf_mlp_kernel(const float* __restrict__ x, Bank bank, float* __restrict__ out, int N,
                   int B) {
  using L = Layout<H>;
  constexpr int P = points_per_thread<H>();
  constexpr int kTile = 32 * P;  // points a step
  extern __shared__ float4 s_raw[];
  float* s_w = reinterpret_cast<float*>(s_raw);
  float* s_out = s_w + kModels * L::kStride;  // two (kTile, kOutStride) buffers
  const int m0 = blockIdx.x * kModels;
  const int n_models = min(kModels, B - m0);
  for (int i = threadIdx.x; i < n_models * L::kStride; i += kThreads) {
    const int64_t b = m0 + i / L::kStride;
    const int f = i % L::kStride;
    float v = 0.f;  // padding
    if (f < L::kB0) {
      v = __ldg(bank.w0 + b * H + f);
    } else if (f < L::kW1) {
      v = __ldg(bank.b0 + b * H + (f - L::kB0));
    } else if (f < L::kB1) {
      v = __ldg(bank.w1 + b * H * H + (f - L::kW1));
    } else if (f < L::kW2) {
      v = __ldg(bank.b1 + b * H + (f - L::kB1));
    } else if (f < L::kB2) {
      v = __ldg(bank.w2 + b * H * H + (f - L::kW2));
    } else if (f < L::kW3) {
      v = __ldg(bank.b2 + b * H + (f - L::kB2));
    } else if (f < L::kB3) {
      v = __ldg(bank.w3 + b * H + (f - L::kW3));
    } else if (f == L::kB3) {
      v = __ldg(bank.b3 + b);
    }
    s_w[i] = v;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool live = warp < n_models;  // idle warps still meet every barrier
  const float* w = s_w + warp * L::kStride;
  const int64_t n0 = (int64_t)blockIdx.y * kPointsPerBlock;
  const int strip = (int)min((int64_t)kPointsPerBlock, (int64_t)N - n0);
  // the points of the next step load while this step computes
  float xn[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    xn[p] = p * 32 + lane < strip ? __ldg(x + n0 + p * 32 + lane) : 0.f;
  }
  for (int s = 0, step = 0; s < strip; s += kTile, ++step) {
    float* tile = s_out + (step & 1) * kTile * kOutStride;
    if (live) {
      float xv[P], yv[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        xv[p] = xn[p];
        const int k = s + kTile + p * 32 + lane;
        xn[p] = k < strip ? __ldg(x + n0 + k) : 0.f;
      }
      evaluate<H, P>(w, xv, yv);
#pragma unroll
      for (int p = 0; p < P; ++p) tile[(p * 32 + lane) * kOutStride + warp] = yv[p];
    }
    // one barrier a step: a buffer is written again two steps later, after
    // every thread has passed the barrier that follows its reads
    __syncthreads();
    const int rows = min(kTile, strip - s);
    for (int e = threadIdx.x; e < kTile * kModels; e += kThreads) {
      const int r = e / kModels;
      const int c = e % kModels;
      if (r < rows && c < n_models) {
        out[(n0 + s + r) * B + m0 + c] = tile[r * kOutStride + c];
      }
    }
  }
}

template <int H>
int launch(const float* x, Bank bank, float* out, int N, int B, cudaStream_t stream) {
  constexpr size_t smem = shared_bytes<H>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cdf_mlp_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((B + kModels - 1) / kModels),
                  (unsigned)((N + kPointsPerBlock - 1) / kPointsPerBlock));
  cdf_mlp_kernel<H><<<grid, kThreads, smem, stream>>>(x, bank, out, N, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a hidden width without an
// instantiation; the Python wrapper raises on anything but 0 and admits
// only H in (4, 8, 16, 32). The staged weights and the two output tiles take
// 11 KB (H = 4) to 73 KB (H = 32) of dynamic shared memory a block.
int wisk_cdf_mlp(const void* x, const void* w0, const void* b0, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* w3,
                 const void* b3, void* out, int N, int B, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const Bank bank = {(const float*)w0, (const float*)b0, (const float*)w1, (const float*)b1,
                     (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3};
  const float* xf = (const float*)x;
  float* o = (float*)out;
  switch (H) {
    case 4: return launch<4>(xf, bank, o, N, B, s);
    case 8: return launch<8>(xf, bank, o, N, B, s);
    case 16: return launch<16>(xf, bank, o, N, B, s);
    case 32: return launch<32>(xf, bank, o, N, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* wisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
