// Backward of the fused anti-aliased SnakeBeta on [B, C, T] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_vits_svc_tpu/ops/pallas_snake.py::snake_alias_cm_pallas_bwd
// (_kernel_padded_bwd). For y = D(s(U(x))) as in snake_alias.cu, per (b, c)
// row of length T and cotangent dy (zero outside [0, T)):
//   u_e[p] = sum_m ae[m] * x[clamp(p - 3 + m)],  u_o[p] = sum_m ao[m] * x[clamp(p - 2 + m)]
//   dE[p]  = sum_m de[m] * dy[p + 2 - m],         dO[p]  = sum_m do[m] * dy[p + 3 - m]
//   ds_e[p] = dE[p] (+ sum_{q<0} dE[q] + dO[q] at p = 0: the clamp onto s_e[0])
//   ds_o[p] = dO[p] (+ sum_{q>T-1} dE[q] + dO[q] at p = T-1: the clamp onto s_o[T-1])
//   du[p]  = ds[p] * (1 + ib * a * sin(2 a u[p]))        for 0 <= p < T
//   dxp[q] = sum_m ae[m] * du_e[q + 3 - m] + ao[m] * du_o[q + 2 - m]
//   dx[t]  = dxp[t], plus sum_{q<0} dxp[q] at t = 0 and sum_{q>T-1} dxp[q] at
//            t = T-1 (the adjoint of the edge replication)
//   dalpha[c] = a * ib * sum_{b,p} ds * u * sin(2 a u)
//   dbeta[c]  = -e^beta * ib^2 * sum_{b,p} ds * sin^2(a u)
// with a = e^alpha[c], ib = 1 / (e^beta[c] + 1e-9). The q < 0 and q > T-1
// ranges are three positions each: nothing further reaches [0, T).
//
// Bound: HBM bytes. The kernel reads x and dy once and writes dx once (12 B
// per element in f32, 6 B in bf16); its ~100 f32 operations per element
// (two 6-tap up FIRs, two 6-tap down-FIR adjoints, sincos on two phases,
// two 6-tap up-FIR adjoints) stay under the bytes at the card's f32 rate. At
// base width a training step (batch 16, 25-frame segments) makes 91 calls
// over 87.7 M elements = 1.05 GB in f32, about 0.31 ms at 3.35 TB/s.
//
// Design: one block per (time tile, c, b), as the forward. The block stages
// x (clamped reads give the edge replication) and dy (zero outside [0, T))
// for its tile plus a 6-sample halo each side in shared memory, recomputes
// u on both phases for the tile plus 3 positions each side, forms du there
// into shared memory, then each thread writes dx outputs from du. The two
// clamp sums are formed from global dy by one thread in the blocks that
// need them. Per-channel dalpha/dbeta: each block sums its own positions
// (a fixed thread order and a fixed shuffle tree) into one slot of a
// [C, B * tiles] buffer; a second kernel sums the slots of each channel in a
// fixed order. No float atomics, so two runs give bitwise-equal gradients.
// Math is f32 for f32 and bf16 inputs. Built without --use_fast_math, as the
// forward: sincosf's fast form loses accuracy as |a*u| grows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 6;
constexpr int kTile = 1024;           // outputs per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXLen = kTile + 12;     // x and dy positions t0-6 .. t0+kTile+5
constexpr int kPLen = kTile + 6;      // phase positions t0-3 .. t0+kTile+2
constexpr int kSumThreads = 256;

struct Taps {
  float ae[kTaps], ao[kTaps], de[kTaps], dodd[kTaps];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ float x_at(const T* row, int p, int len) {
  return to_f32(row[min(max(p, 0), len - 1)]);
}

template <typename T>
__device__ __forceinline__ float dy_at(const T* row, int p, int len) {
  return (p >= 0 && p < len) ? to_f32(row[p]) : 0.0f;
}

// dE[p] + dO[p] at any p, from global dy
template <typename T>
__device__ float dsum_at(const T* dyr, const Taps& taps, int p, int len) {
  float acc = 0.0f;
  for (int m = 0; m < kTaps; ++m) {
    acc = acc + taps.de[m] * dy_at(dyr, p + 2 - m, len);
    acc = acc + taps.dodd[m] * dy_at(dyr, p + 3 - m, len);
  }
  return acc;
}

__device__ __forceinline__ float du_at(const float* du, int l) {
  return (l >= 0 && l < kPLen) ? du[l] : 0.0f;
}

// dxp at local position j (q = t0 + j), any j; du is zero outside [0, T)
__device__ float dxp_at(const float* du_e, const float* du_o, const Taps& taps, int j) {
  float acc = 0.0f;
  for (int m = 0; m < kTaps; ++m) {
    acc = acc + taps.ae[m] * du_at(du_e, j + 6 - m);
    acc = acc + taps.ao[m] * du_at(du_o, j + 5 - m);
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_alias_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part_a, float* __restrict__ part_b,
                       const float* __restrict__ alpha, const float* __restrict__ beta,
                       const Taps taps, int channels, int len) {
  __shared__ float xs[kXLen];
  __shared__ float dys[kXLen];
  __shared__ float du_e[kPLen];
  __shared__ float du_o[kPLen];
  __shared__ float edge[2];
  __shared__ float red[2][kWarps];

  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_off = ((long long)b * channels + c) * len;
  const T* xr = x + row_off;
  const T* dyr = dy + row_off;
  T* dxr = dx + row_off;
  const int t0 = blockIdx.x * kTile;
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);

  for (int i = threadIdx.x; i < kXLen; i += kThreads) {
    xs[i] = x_at(xr, t0 - 6 + i, len);
    dys[i] = dy_at(dyr, t0 - 6 + i, len);
  }
  // the clamp sums: positions -3..-1 onto s_e[0], T..T+2 onto s_o[T-1]
  if (threadIdx.x == 0) {
    float head = 0.0f;
    if (t0 - 3 <= 0) {
      for (int p = -3; p < 0; ++p) head = head + dsum_at(dyr, taps, p, len);
    }
    edge[0] = head;
  }
  if (threadIdx.x == 32) {
    float tail = 0.0f;
    if (t0 + kTile + 2 >= len - 1) {
      for (int p = len; p < len + 3; ++p) tail = tail + dsum_at(dyr, taps, p, len);
    }
    edge[1] = tail;
  }
  __syncthreads();

  // phases at p = t0 - 3 + l: x[p - 3 + m] is xs[l + m], x[p - 2 + m] is
  // xs[l + 1 + m], dy[p + 2 - m] is dys[l + 5 - m], dy[p + 3 - m] is dys[l + 6 - m]
  float sum_a = 0.0f, sum_b = 0.0f;
  for (int l = threadIdx.x; l < kPLen; l += kThreads) {
    const int p = t0 - 3 + l;
    float ge = 0.0f, go = 0.0f;
    if (p >= 0 && p < len) {
      float ue = taps.ae[0] * xs[l];
      float uo = taps.ao[0] * xs[l + 1];
      float dse = taps.de[0] * dys[l + 5];
      float dso = taps.dodd[0] * dys[l + 6];
      for (int m = 1; m < kTaps; ++m) {
        ue = ue + taps.ae[m] * xs[l + m];
        uo = uo + taps.ao[m] * xs[l + 1 + m];
        dse = dse + taps.de[m] * dys[l + 5 - m];
        dso = dso + taps.dodd[m] * dys[l + 6 - m];
      }
      if (p == 0) dse = dse + edge[0];
      if (p == len - 1) dso = dso + edge[1];
      float sne, cse, sno, cso;
      sincosf(a * ue, &sne, &cse);
      sincosf(a * uo, &sno, &cso);
      const float s2e = 2.0f * sne * cse;  // sin(2 a u)
      const float s2o = 2.0f * sno * cso;
      ge = dse * (1.0f + ib * a * s2e);
      go = dso * (1.0f + ib * a * s2o);
      if (p >= t0 && p < t0 + kTile) {  // each position counted by one block
        sum_a = sum_a + (dse * ue * s2e + dso * uo * s2o);
        sum_b = sum_b + (dse * sne * sne + dso * sno * sno);
      }
    }
    du_e[l] = ge;
    du_o[l] = go;
  }
  __syncthreads();

  // dx[t] with t = t0 + j: du_e[t + 3 - m] is du_e[j + 6 - m], du_o[t + 2 - m] is du_o[j + 5 - m]
  for (int j = threadIdx.x; j < kTile && t0 + j < len; j += kThreads) {
    float acc = taps.ae[0] * du_e[j + 6] + taps.ao[0] * du_o[j + 5];
    for (int m = 1; m < kTaps; ++m) {
      acc = acc + taps.ae[m] * du_e[j + 6 - m];
      acc = acc + taps.ao[m] * du_o[j + 5 - m];
    }
    const int t = t0 + j;
    if (t == 0) {
      for (int q = -3; q < 0; ++q) acc = acc + dxp_at(du_e, du_o, taps, q - t0);
    }
    if (t == len - 1) {
      for (int q = len; q < len + 3; ++q) acc = acc + dxp_at(du_e, du_o, taps, q - t0);
    }
    store(dxr + t, acc);
  }

  sum_a = warp_sum(sum_a);
  sum_b = warp_sum(sum_b);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = sum_a;
    red[1][warp] = sum_b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = red[0][0], sb = red[1][0];
    for (int w = 1; w < kWarps; ++w) {
      sa = sa + red[0][w];
      sb = sb + red[1][w];
    }
    const long long slot = (long long)c * (gridDim.z * gridDim.x) + (long long)b * gridDim.x
                           + blockIdx.x;
    part_a[slot] = sa;
    part_b[slot] = sb;
  }
}

// dalpha[c], dbeta[c] from the n_part slots of channel c, summed in a fixed order
__global__ void __launch_bounds__(kSumThreads)
snake_alias_bwd_sum_kernel(const float* __restrict__ part_a, const float* __restrict__ part_b,
                           int n_part, const float* __restrict__ alpha,
                           const float* __restrict__ beta, float* __restrict__ dalpha,
                           float* __restrict__ dbeta) {
  __shared__ float red[2][kSumThreads / 32];
  const int c = blockIdx.x;
  const long long base = (long long)c * n_part;
  float sa = 0.0f, sb = 0.0f;
  for (int i = threadIdx.x; i < n_part; i += kSumThreads) {
    sa = sa + part_a[base + i];
    sb = sb + part_b[base + i];
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = sa;
    red[1][warp] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = red[0][0], tb = red[1][0];
    for (int w = 1; w < kSumThreads / 32; ++w) {
      ta = ta + red[0][w];
      tb = tb + red[1][w];
    }
    const float a = expf(alpha[c]);
    const float eb = expf(beta[c]);
    const float ib = 1.0f / (eb + 1e-9f);
    dalpha[c] = a * ib * ta;
    dbeta[c] = -eb * ib * ib * tb;
  }
}

}  // namespace

extern "C" {

// Outputs per block along T: the caller sizes the partial-sum buffers as
// [C, B * ceil(T / tile)] float32.
int snake_alias_backward_tile() { return kTile; }

// x, dy, dx: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); part_a, part_b: device float32 [C, B * ceil(T / tile)]
// scratch; alpha, beta, dalpha, dbeta: device float32 [C]; taps: host
// float32[24] as ae, ao, de, do. Launches both kernels on `stream` and
// returns the first non-zero cudaGetLastError().
int snake_alias_backward(const void* x, const void* dy, void* dx, void* part_a, void* part_b,
                         const void* alpha, const void* beta, void* dalpha, void* dbeta,
                         const float* taps, int is_bf16, int batch, int channels, int len,
                         void* stream) {
  Taps t;
  for (int m = 0; m < kTaps; ++m) {
    t.ae[m] = taps[m];
    t.ao[m] = taps[kTaps + m];
    t.de[m] = taps[2 * kTaps + m];
    t.dodd[m] = taps[3 * kTaps + m];
  }
  const int tiles = (len + kTile - 1) / kTile;
  const dim3 grid(tiles, channels, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  float* pa = static_cast<float*>(part_a);
  float* pb = static_cast<float*>(part_b);
  if (is_bf16) {
    snake_alias_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), pa, pb, a, b, t, channels, len);
  } else {
    snake_alias_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx),
        pa, pb, a, b, t, channels, len);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  snake_alias_bwd_sum_kernel<<<channels, kSumThreads, 0, s>>>(
      pa, pb, batch * tiles, a, b, static_cast<float*>(dalpha), static_cast<float*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
