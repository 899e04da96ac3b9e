// Device code shared by the snake kernels (snake_alias.cu, snake_alias_bwd.cu,
// snake_alias_strips.cu, snake_alias_mma.cu) and the fused AMP iteration
// (amp_iter.cu): the taps, the pointwise snake and its sine, clamped loads,
// the 16-byte run loads and stores, and the warp body that turns one segment
// of a (b, c) row into outputs. snake_alias.cu states what the function
// computes.
//
// The unit of work is a warp segment: one warp, kSegLen = 31 * kRun
// consecutive outputs of one row. Lane l holds the run of kRun outputs
// [s + l kRun, s + (l + 1) kRun) and computes the phases at the kRun
// positions three to the left of it, so an output's right-hand phases come
// from lane l + 1 by warp shuffles; lane 31 only computes phases for lane 30.
// No shared memory and no barrier: the warps of a block are independent, and
// a block may hold the segments of several short rows.
//
// The direct and the strips kernels both run `snake_segment`, so each
// output's FMAs are the same instructions in the same order whatever the
// launch shape: their results are bitwise equal.
//
// What bounds it: HBM bytes in principle (x read once, out written once);
// in fact instruction issue, at 43% of the bytes bound at the long stages
// on an H100 (PERF.md). An output costs two sinf, 22 unfused up-FIR
// instructions, 12 down-FIR FMAs and about 2 shuffles; no shared memory.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace snake_alias {

constexpr int kTaps = 6;
constexpr int kRun = 8;                         // consecutive outputs a lane
constexpr int kLanes = 32;
constexpr int kSegLen = (kLanes - 1) * kRun;    // outputs a warp segment
constexpr int kWarps = 8;                       // warps a block
constexpr int kThreads = kWarps * kLanes;
constexpr unsigned kFull = 0xffffffffu;

// elements of one 16-byte access; a run is kRun / kVec of them
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

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

// The snake, and sq = sin^2(th), s2 = sin(2 th) for its derivative, by
// CUDA's sinf and sincosf (no --use_fast_math: __sinf's error grows with
// |th|). snake_probe.py measures what they cost against a branch-free
// polynomial and against the MUFU intrinsics.
__device__ __forceinline__ float snake(float u, float a, float ib) {
  const float s = sinf(u * a);
  return u + ib * (s * s);
}

__device__ __forceinline__ void sin_sq_sin2(float th, float& sq, float& s2) {
  float s, c;
  sincosf(th, &s, &c);
  sq = s * s;
  s2 = 2.0f * s * c;
}

template <typename T>
__device__ __forceinline__ float x_at(const T* row, int p, int len) {
  return to_f32(row[min(max(p, 0), len - 1)]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v[i] = p[i], i < kRun, as 16-byte loads (p 16-byte aligned)
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kRun]) {
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    const float4 q = *reinterpret_cast<const float4*>(p + 4 * k);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

// bf16 to f32 is exact: the 16 bits are the top half of the float
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kRun]) {
#pragma unroll
  for (int k = 0; k < kRun / 8; ++k) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + 8 * k);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * k + 2 * i] = __uint_as_float(w[i] << 16);
      v[8 * k + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kRun]) {
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    *reinterpret_cast<float4*>(p + 4 * k) =
        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[kRun]) {
#pragma unroll
  for (int k = 0; k < kRun / 8; ++k) {
    *reinterpret_cast<uint4*>(p + 8 * k) =
        make_uint4(bf16_pair(v[8 * k], v[8 * k + 1]), bf16_pair(v[8 * k + 2], v[8 * k + 3]),
                   bf16_pair(v[8 * k + 4], v[8 * k + 5]), bf16_pair(v[8 * k + 6], v[8 * k + 7]));
  }
}

// row[p] with the index clamped to [0, len) (edge replication), or with
// `zero`, 0 outside [0, len)
template <bool zero, typename T>
__device__ __forceinline__ float sample(const T* row, int p, int len) {
  if (zero) return (p >= 0 && p < len) ? to_f32(row[p]) : 0.0f;
  return x_at(row, p, len);
}

// v[i] = sample<zero>(row, q0 + i, len), 16 bytes at a time where the run
// lies inside the row at an aligned address
template <bool zero, typename T>
__device__ __forceinline__ void load_run(const T* row, int q0, int len, float (&v)[kRun]) {
  if (q0 >= 0 && q0 + kRun <= len && aligned16(row + q0)) {
    load_vec(row + q0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = sample<zero>(row, q0 + i, len);
  }
}

// row[q0 + i] = v[i] for the q0 + i in [lo, hi)
template <typename T>
__device__ __forceinline__ void store_run(T* row, int q0, int lo, int hi, const float (&v)[kRun]) {
  if (q0 >= lo && q0 + kRun <= hi && aligned16(row + q0)) {
    store_vec(row + q0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (q0 + i >= lo && q0 + i < hi) store(row + q0 + i, v[i]);
    }
  }
}

// xe[i] = sample<zero>(row, q0 - 6 + i, len), i < kRun + 6: each lane loads
// its own run, the 6 samples before it come from the lane below (lane 0
// loads them)
template <bool zero, typename T>
__device__ __forceinline__ void stage_run(const T* row, int q0, int len, int lane,
                                          float (&xe)[kRun + 6]) {
  float own[kRun];
  load_run<zero>(row, q0, len, own);
#pragma unroll
  for (int i = 0; i < kRun; ++i) xe[6 + i] = own[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = __shfl_up_sync(kFull, own[kRun - 6 + i], 1);
    if (lane == 0) v = sample<zero>(row, q0 - 6 + i, len);
    xe[i] = v;
  }
}

// se = sum_m ae[m] * xe[j + m], so = sum_m ao[m] * xe[j + 1 + m]: the up-FIR
// phases at the position of xe[j + 3]. Each product and each sum is rounded
// on its own (no FMA), in the plain version's order, so that u, and with it
// the sine's argument a * u, equals the plain version's to the bit: at
// |a u| ~ 1e3 one rounding step of u moves sin(a u) by ~1e-4.
template <typename TapsT>
__device__ __forceinline__ void up_fir(const TapsT& taps, const float (&xe)[kRun + 6], int j,
                                       float& se, float& so) {
  se = __fmul_rn(taps.ae[0], xe[j]);
  so = __fmul_rn(taps.ao[0], xe[j + 1]);
#pragma unroll
  for (int m = 1; m < kTaps; ++m) {
    se = __fadd_rn(se, __fmul_rn(taps.ae[m], xe[j + m]));
    so = __fadd_rn(so, __fmul_rn(taps.ao[m], xe[j + 1 + m]));
  }
}

// the first 6 (E) and 5 (O) values of lane + 1 after each lane's kRun own
__device__ __forceinline__ void halo_from_next(float (&e)[kRun + 6], float (&o)[kRun + 5]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) e[kRun + i] = __shfl_down_sync(kFull, e[i], 1);
#pragma unroll
  for (int i = 0; i < 5; ++i) o[kRun + i] = __shfl_down_sync(kFull, o[i], 1);
}

// The warp segment starting at output s of one (b, c) row of length `len`:
// writes the outputs in [lo, hi) (s <= lo < hi <= min(s + kSegLen, len)).
// Called by all 32 lanes of a warp with the same arguments.
template <typename T>
__device__ __forceinline__ void snake_segment(const T* __restrict__ xr, T* __restrict__ outr,
                                              int s, int lo, int hi, int len, float a, float ib,
                                              const Taps& taps) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int q0 = s + lane * kRun;  // this lane's first output
  const int p0 = q0 - 3;           // and first phase position
  float xe[kRun + 6];              // x[p0 - 3 + i]
  stage_run<false>(xr, q0, len, lane, xe);

  float ph_e[kRun + 6], ph_o[kRun + 5];  // E, O at p0 + j
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    float se, so;
    up_fir(taps, xe, j, se, so);
    ph_e[j] = snake(se, a, ib);
    ph_o[j] = snake(so, a, ib);
  }

  // the clamps E[p] = O[p] = E[0] for p < 0 and = O[T-1] for p > T-1, from
  // the lane that holds position 0 or T-1 (this warp does whenever its
  // outputs reach them)
  const int w0 = s - 3;  // the warp's first phase position
  if (w0 < 0) {
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < kRun; ++j) v = (p0 + j == 0) ? ph_e[j] : v;
    const float head = __shfl_sync(kFull, v, -w0 / kRun);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (p0 + j < 0) ph_e[j] = ph_o[j] = head;
    }
  }
  if (w0 + kLanes * kRun > len) {
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < kRun; ++j) v = (p0 + j == len - 1) ? ph_o[j] : v;
    const float tail = __shfl_sync(kFull, v, (len - 1 - w0) / kRun);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (p0 + j > len - 1) ph_e[j] = ph_o[j] = tail;
    }
  }
  halo_from_next(ph_e, ph_o);

  // out[q0 + i]: E[q0 + i - 2 + m] is ph_e[i + 1 + m], O[q0 + i - 3 + m] is ph_o[i + m]
  float y[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    float acc = taps.de[0] * ph_e[i + 1] + taps.dodd[0] * ph_o[i];
#pragma unroll
    for (int m = 1; m < kTaps; ++m) {
      acc = acc + taps.de[m] * ph_e[i + 1 + m];
      acc = acc + taps.dodd[m] * ph_o[i + m];
    }
    y[i] = acc;
  }
  if (lane < kLanes - 1) store_run(outr, q0, lo, hi, y);
}

}  // namespace snake_alias
