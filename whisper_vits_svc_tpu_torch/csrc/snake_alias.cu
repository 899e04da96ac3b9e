// Fused anti-aliased SnakeBeta on [B, C, T] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_vits_svc_tpu/ops/pallas_snake.py::snake_alias_cm_pallas
// (_kernel_nocopy and _kernel_padded, shared math in snake_range). It
// computes, per (b, c) row of length T, with x edge-replicated by clamping
// the index:
//   se[p] = sum_m ae[m] * x[clamp(p - 3 + m)]      (even phase of the x2 up)
//   so[p] = sum_m ao[m] * x[clamp(p - 2 + m)]      (odd phase)
//   s(u)  = u + sin^2(e^alpha[c] * u) / (e^beta[c] + 1e-9)
//   E[p] = s(se[p]), O[p] = s(so[p]) for 0 <= p < T;
//   E[p] = O[p] = s(se[0]) for p < 0 and = s(so[T-1]) for p > T-1
//   out[t] = sum_m de[m] * E[t - 2 + m] + do[m] * O[t - 3 + m]
// The 24 taps come from the caller (nn/snake.py::_polyphase_taps(12, 12),
// offsets (-3, -2, -2, -3)).
//
// Bound: HBM bytes. The kernel reads x once and writes out once (8 B per
// element in f32, 4 B in bf16); the ~58 f32 operations per element stay
// under the bytes at the card's f32 rate. At base width one 1020-frame chunk
// makes 91 launches over 223.6 M elements = 1.79 GB in f32, a bound of about
// 0.53 ms per chunk at 3.35 TB/s; per call 1.95 / 3.90 / 7.79 / 7.79 / 7.79
// us for the stages [160, 5100], [80, 20400], [40, 81600], [20, 163200],
// [10, 326400].
//
// Design: one block per (time tile, c, b). The block stages its x tile plus
// a 6-sample halo on each side in shared memory (clamped reads give the edge
// replication), computes both snake'd phases for the tile plus 3 positions
// each side into shared memory, then each thread produces outputs from the
// phases. Every element of x is read from HBM once per tile (plus 12 halo
// samples), every output written once. Math is f32 for f32 and bf16 inputs.
// Built without --use_fast_math: sinf's fast form loses accuracy as |a*u|
// grows, and the tolerance against the plain version is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 6;
constexpr int kTile = 1024;           // outputs per block
constexpr int kThreads = 256;
constexpr int kXLen = kTile + 12;     // x positions t0-6 .. t0+kTile+5
constexpr int kPLen = kTile + 6;      // phase positions t0-3 .. t0+kTile+2

struct Taps {
  float ae[kTaps], ao[kTaps], de[kTaps], dodd[kTaps];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float snake(float u, float a, float ib) {
  const float s = sinf(u * a);
  return u + ib * (s * s);
}

template <typename T>
__device__ __forceinline__ float x_at(const T* row, int p, int len) {
  return to_f32(row[min(max(p, 0), len - 1)]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_alias_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ alpha, const float* __restrict__ beta,
                   const Taps taps, int channels, int len) {
  __shared__ float xs[kXLen];
  __shared__ float ph_e[kPLen];
  __shared__ float ph_o[kPLen];
  __shared__ float edge[2];

  const int c = blockIdx.y;
  const long long row_off = ((long long)blockIdx.z * channels + c) * len;
  const T* xr = x + row_off;
  T* outr = out + row_off;
  const int t0 = blockIdx.x * kTile;
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);

  for (int i = threadIdx.x; i < kXLen; i += kThreads) {
    xs[i] = x_at(xr, t0 - 6 + i, len);
  }
  // clamp values of the downsample input: s(se[0]) and s(so[T-1])
  if (threadIdx.x == 0 && t0 - 3 < 0) {
    float se = taps.ae[0] * x_at(xr, -3, len);
    for (int m = 1; m < kTaps; ++m) se = se + taps.ae[m] * x_at(xr, m - 3, len);
    edge[0] = snake(se, a, ib);
  }
  if (threadIdx.x == 32 && t0 + kTile + 2 > len - 1) {
    float so = taps.ao[0] * x_at(xr, len - 3, len);
    for (int m = 1; m < kTaps; ++m) so = so + taps.ao[m] * x_at(xr, len - 3 + m, len);
    edge[1] = snake(so, a, ib);
  }
  __syncthreads();

  // phases at p = t0 - 3 + l; x[p - 3 + m] is xs[l + m], x[p - 2 + m] is xs[l + 1 + m]
  for (int l = threadIdx.x; l < kPLen; l += kThreads) {
    const int p = t0 - 3 + l;
    float e, o;
    if (p < 0) {
      e = o = edge[0];
    } else if (p > len - 1) {
      e = o = edge[1];
    } else {
      float se = taps.ae[0] * xs[l];
      float so = taps.ao[0] * xs[l + 1];
      for (int m = 1; m < kTaps; ++m) {
        se = se + taps.ae[m] * xs[l + m];
        so = so + taps.ao[m] * xs[l + 1 + m];
      }
      e = snake(se, a, ib);
      o = snake(so, a, ib);
    }
    ph_e[l] = e;
    ph_o[l] = o;
  }
  __syncthreads();

  // out[t] with t = t0 + j: E[t - 2 + m] is ph_e[j + 1 + m], O[t - 3 + m] is ph_o[j + m]
  for (int j = threadIdx.x; j < kTile && t0 + j < len; j += kThreads) {
    float acc = taps.de[0] * ph_e[j + 1] + taps.dodd[0] * ph_o[j];
    for (int m = 1; m < kTaps; ++m) {
      acc = acc + taps.de[m] * ph_e[j + 1 + m];
      acc = acc + taps.dodd[m] * ph_o[j + m];
    }
    store(outr + t0 + j, acc);
  }
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); alpha, beta: device float32 [C]; taps: host float32[24] as
// ae, ao, de, do. Launches on `stream` and returns cudaGetLastError().
int snake_alias_forward(const void* x, void* out, const void* alpha, const void* beta,
                        const float* taps, int is_bf16, int batch, int channels, int len,
                        void* stream) {
  Taps t;
  for (int m = 0; m < kTaps; ++m) {
    t.ae[m] = taps[m];
    t.ao[m] = taps[kTaps + m];
    t.de[m] = taps[2 * kTaps + m];
    t.dodd[m] = taps[3 * kTaps + m];
  }
  const dim3 grid((len + kTile - 1) / kTile, channels, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  if (is_bf16) {
    snake_alias_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), a, b, t,
        channels, len);
  } else {
    snake_alias_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a, b, t, channels, len);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
