// Device code shared by the forward snake kernels (snake_alias.cu,
// snake_alias_strips.cu, snake_alias_mma.cu) and the fused AMP iteration
// (amp_iter.cu): the taps, the pointwise snake, clamped loads, and the body
// that turns one tile of a (b, c) row into outputs. snake_alias.cu states
// what the function computes.
//
// The direct and the strips kernels both run `snake_tile`, so each output's
// FMAs are the same instructions in the same order whatever the launch
// shape: their results are bitwise equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace snake_alias {

constexpr int kTaps = 6;
constexpr int kTile = 1024;           // outputs per tile
constexpr int kThreads = 256;
constexpr int kXLen = kTile + 12;     // x positions t0-6 .. t0+kTile+5
constexpr int kPLen = kTile + 6;      // phase positions t0-3 .. t0+kTile+2

struct Taps {
  float ae[kTaps], ao[kTaps], de[kTaps], dodd[kTaps];
};

// taps: host float32[24] as ae, ao, de, do
inline Taps load_taps(const float* taps) {
  Taps t;
  for (int m = 0; m < kTaps; ++m) {
    t.ae[m] = taps[m];
    t.ao[m] = taps[kTaps + m];
    t.de[m] = taps[2 * kTaps + m];
    t.dodd[m] = taps[3 * kTaps + m];
  }
  return t;
}

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

// s(se[0]): the downsample input before position 0
template <typename T>
__device__ __forceinline__ float head_clamp(const T* xr, int len, float a, float ib,
                                            const Taps& taps) {
  float se = taps.ae[0] * x_at(xr, -3, len);
  for (int m = 1; m < kTaps; ++m) se = se + taps.ae[m] * x_at(xr, m - 3, len);
  return snake(se, a, ib);
}

// s(so[T-1]): the downsample input past position T-1
template <typename T>
__device__ __forceinline__ float tail_clamp(const T* xr, int len, float a, float ib,
                                            const Taps& taps) {
  float so = taps.ao[0] * x_at(xr, len - 3, len);
  for (int m = 1; m < kTaps; ++m) so = so + taps.ao[m] * x_at(xr, len - 3 + m, len);
  return snake(so, a, ib);
}

// Outputs [t0, min(t0 + kTile, t_hi)) of one (b, c) row of length `len`
// (t_hi <= len), by all kThreads threads of the block. xs, ph_e, ph_o, edge
// are shared memory of kXLen, kPLen, kPLen and 2 floats. Ends without a
// barrier: the caller synchronizes before the buffers are written again.
template <typename T>
__device__ __forceinline__ void snake_tile(const T* __restrict__ xr, T* __restrict__ outr,
                                           int t0, int t_hi, int len, float a, float ib,
                                           const Taps& taps, float* xs, float* ph_e,
                                           float* ph_o, float* edge) {
  const int n = min(kTile, t_hi - t0);
  for (int i = threadIdx.x; i < n + 12; i += kThreads) {
    xs[i] = x_at(xr, t0 - 6 + i, len);
  }
  // clamp values of the downsample input: s(se[0]) and s(so[T-1])
  if (threadIdx.x == 0 && t0 - 3 < 0) {
    edge[0] = head_clamp(xr, len, a, ib, taps);
  }
  if (threadIdx.x == 32 && t0 + n + 2 > len - 1) {
    edge[1] = tail_clamp(xr, len, a, ib, taps);
  }
  __syncthreads();

  // phases at p = t0 - 3 + l; x[p - 3 + m] is xs[l + m], x[p - 2 + m] is xs[l + 1 + m]
  for (int l = threadIdx.x; l < n + 6; l += kThreads) {
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
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float acc = taps.de[0] * ph_e[j + 1] + taps.dodd[0] * ph_o[j];
    for (int m = 1; m < kTaps; ++m) {
      acc = acc + taps.de[m] * ph_e[j + 1 + m];
      acc = acc + taps.dodd[m] * ph_o[j + m];
    }
    store(outr + t0 + j, acc);
  }
}

}  // namespace snake_alias
