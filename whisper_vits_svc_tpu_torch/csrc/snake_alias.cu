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
// Design: one block per (time tile, c, b); the tile body is
// snake_alias.cuh::snake_tile, shared with the strips kernel
// (snake_alias_strips.cu). The block stages its x tile plus a 6-sample halo on each side in shared memory (clamped reads give the edge
// replication), computes both snake'd phases for the tile plus 3 positions
// each side into shared memory, then each thread produces outputs from the
// phases. Every element of x is read from HBM once per tile (plus 12 halo
// samples), every output written once. Math is f32 for f32 and bf16 inputs.
// Built without --use_fast_math: sinf's fast form loses accuracy as |a*u|
// grows, and the tolerance against the plain version is f32.

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

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
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);
  snake_tile(x + row_off, out + row_off, blockIdx.x * kTile, len, len, a, ib, taps, xs, ph_e,
             ph_o, edge);
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); alpha, beta: device float32 [C]; taps: host float32[24] as
// ae, ao, de, do. Launches on `stream` and returns cudaGetLastError().
int snake_alias_forward(const void* x, void* out, const void* alpha, const void* beta,
                        const float* taps, int is_bf16, int batch, int channels, int len,
                        void* stream) {
  const Taps t = load_taps(taps);
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
