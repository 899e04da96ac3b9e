// One fused AMP dilation iteration on [B, C, T] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_vits_svc_tpu/ops/pallas_amp.py::amp_iter (_kernel). It computes
//   out = x + conv2_{k,1}( SnakeAlias_2( conv1_{k,d}( SnakeAlias_1(x) ) ) )
// with both convolutions zero-padded ("same": (k d - d) / 2 and (k - 1) / 2)
// and both snakes edge-replicated, exactly as the four modules composed:
//   s1 = SnakeAlias_1(x)                  x[p < 0] = x[0], x[p > T-1] = x[T-1]
//   c1 = b1 + sum_m W1_m s1[. + m d - r1]   s1 = 0 outside [0, T)
//   s2 = SnakeAlias_2(c1)                 c1[p < 0] = c1[0], c1[p > T-1] = c1[T-1]
//   c2 = b2 + sum_m W2_m s2[. + m - r2]     s2 = 0 outside [0, T)
// with r1 = d (k - 1) / 2, r2 = (k - 1) / 2, W_m the (C, C) channel mix of
// tap m (weight norm folded by the caller), and SnakeAlias as
// snake_alias.cu states it, each with its own downsample clamps (s_e[0]
// before position 0, s_o[T-1] past T-1) against global positions.
//
// Design: one block per (batch, time tile), all C <= 32 channels. A tile of
// tt outputs needs s2 over [-r2, tt + r2), c1 over 6 more a side, s1 over r1
// more, x over 6 more: a halo of r2 + 12 + r1 <= 42 samples a side. Four
// [C, tt + 2 halo] buffers in shared memory are reused through the chain
// (x -> phases -> s1 -> c1 -> phases -> s2); both folded kernels sit beside
// them as [tap][in][out padded to 4], so that a thread reads four output
// channels' weights as one broadcast float4. In the convolutions a thread
// owns two time positions and every output channel: 2 x C accumulators in
// registers, per (tap, in) two shared loads of the signal and C / 4 of the
// weights for 2 C FMAs. Edge rules are index clamps: a position outside
// [0, T) computes at the clamped position (x, c1) or is zeroed (s1, s2), so
// every tile is self-contained and any T >= 1 runs, shorter than the halo
// too. Sums are f32 FMAs on the CUDA cores (the TPU kernel runs its per-tap
// products at Precision.HIGHEST; plain TF32 would err by about 1e-3).
//
// Bound: f32 operations, not bytes. Per output element the kernel moves 8 B
// (4 in bf16) and does about 4 k C + 116 operations (two k-tap C x C channel
// mixes, two snakes); at [20, 163200], k = 11 that is 26 MB (7.8 us at
// 3.35 TB/s) against 3.2 GFLOP (48 us at 67 TFLOP/s).

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

// Shared memory, in bytes, that a launch with these sizes asks for.
long long smem_bytes(int channels, int k, int d, int tile) {
  const long long cp = 4 * ((channels + 3) / 4);
  const long long halo = (k - 1) / 2 + 12 + d * (k - 1) / 2;
  return 4 * (2 * (long long)k * channels * cp + 6 * cp + 4 * channels * (tile + 2 * halo));
}

constexpr int kAmpThreads = 256;
constexpr int kMaxC = 32;

struct Args {
  const void* x;
  void* out;
  const float *w1, *b1, *a1, *be1, *w2, *b2, *a2, *be2;  // w: torch (O, I, K)
  Taps taps;
  int channels, len, k, d, tt, stride;
};

// SnakeAlias over `out_len` positions from out_lo (relative to t0) of every
// channel: `in` covers [out_lo - 6, out_lo + out_len + 6), edge-replicated;
// the result goes to `dst` (index 0 = out_lo), zero outside [0, len).
// ph_e / ph_o hold the phases over [out_lo - 3, out_lo + out_len + 3).
__device__ __forceinline__ void snake_stage(const float* in, float* ph_e, float* ph_o,
                                            float* dst, const float* a_s, const float* ib_s,
                                            const Taps& taps, int channels, int stride,
                                            int out_lo, int out_len, int t0, int len) {
  const int ext = out_len + 6;
  for (int idx = threadIdx.x; idx < channels * ext; idx += kAmpThreads) {
    const int c = idx / ext, l = idx - c * ext;
    const float* row = in + c * stride;
    const int g = t0 + out_lo - 3 + l;  // global phase position
    const float a = a_s[c], ib = ib_s[c];
    float e, o;
    if (g < 0) {
      // s_e[0]: x[-3 + m] sits at index (-t0 - 3 + m) - (out_lo - 6)
      const float* p = row + (3 - t0 - out_lo);
      float se = taps.ae[0] * p[0];
      for (int m = 1; m < kTaps; ++m) se = se + taps.ae[m] * p[m];
      e = o = snake(se, a, ib);
    } else if (g > len - 1) {
      // s_o[T-1]: x[T - 3 + m] sits at index (len - 3 - t0 + m) - (out_lo - 6)
      const float* p = row + (len + 3 - t0 - out_lo);
      float so = taps.ao[0] * p[0];
      for (int m = 1; m < kTaps; ++m) so = so + taps.ao[m] * p[m];
      e = o = snake(so, a, ib);
    } else {
      float se = taps.ae[0] * row[l];
      float so = taps.ao[0] * row[l + 1];
      for (int m = 1; m < kTaps; ++m) {
        se = se + taps.ae[m] * row[l + m];
        so = so + taps.ao[m] * row[l + 1 + m];
      }
      e = snake(se, a, ib);
      o = snake(so, a, ib);
    }
    ph_e[c * stride + l] = e;
    ph_o[c * stride + l] = o;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < channels * out_len; idx += kAmpThreads) {
    const int c = idx / out_len, j = idx - c * out_len;
    const float* pe = ph_e + c * stride + j + 1;
    const float* po = ph_o + c * stride + j;
    float acc = taps.de[0] * pe[0] + taps.dodd[0] * po[0];
    for (int m = 1; m < kTaps; ++m) {
      acc = acc + taps.de[m] * pe[m];
      acc = acc + taps.dodd[m] * po[m];
    }
    const int g = t0 + out_lo + j;
    dst[c * stride + j] = (g < 0 || g > len - 1) ? 0.0f : acc;
  }
  __syncthreads();
}

// acc[o] = bias[o] + sum_m sum_i w[m][i][o] * in[i][j + m * step] at the two
// positions ja, jb (already clamped into the buffer)
template <int OP>
__device__ __forceinline__ void conv_pair(const float* in, const float* w, const float* bias,
                                          int channels, int k, int step, int stride, int ja,
                                          int jb, float (&acc_a)[4 * OP], float (&acc_b)[4 * OP]) {
  constexpr int CP = 4 * OP;
#pragma unroll
  for (int o = 0; o < CP; ++o) acc_a[o] = acc_b[o] = bias[o];
  for (int m = 0; m < k; ++m) {
    const float* pa = in + ja + m * step;
    const float* pb = in + jb + m * step;
    const float4* wm = reinterpret_cast<const float4*>(w + m * channels * CP);
    for (int i = 0; i < channels; ++i) {
      const float sa = pa[i * stride], sb = pb[i * stride];
#pragma unroll
      for (int o4 = 0; o4 < OP; ++o4) {
        const float4 wv = wm[i * OP + o4];
        acc_a[4 * o4 + 0] = fmaf(wv.x, sa, acc_a[4 * o4 + 0]);
        acc_a[4 * o4 + 1] = fmaf(wv.y, sa, acc_a[4 * o4 + 1]);
        acc_a[4 * o4 + 2] = fmaf(wv.z, sa, acc_a[4 * o4 + 2]);
        acc_a[4 * o4 + 3] = fmaf(wv.w, sa, acc_a[4 * o4 + 3]);
        acc_b[4 * o4 + 0] = fmaf(wv.x, sb, acc_b[4 * o4 + 0]);
        acc_b[4 * o4 + 1] = fmaf(wv.y, sb, acc_b[4 * o4 + 1]);
        acc_b[4 * o4 + 2] = fmaf(wv.z, sb, acc_b[4 * o4 + 2]);
        acc_b[4 * o4 + 3] = fmaf(wv.w, sb, acc_b[4 * o4 + 3]);
      }
    }
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kAmpThreads) amp_iter_kernel(const Args p) {
  constexpr int CP = 4 * OP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.channels, k = p.k, d = p.d, tt = p.tt, stride = p.stride, len = p.len;
  float* w1s = smem;                      // [k][C][CP]
  float* w2s = w1s + k * C * CP;
  float* b1s = w2s + k * C * CP;          // [CP] each, zero past C
  float* b2s = b1s + CP;
  float* a1s = b2s + CP;                  // e^alpha
  float* ib1s = a1s + CP;                 // 1 / (e^beta + 1e-9)
  float* a2s = ib1s + CP;
  float* ib2s = a2s + CP;
  float* buf_a = ib2s + CP;               // [C][stride] each
  float* buf_b = buf_a + C * stride;
  float* buf_c = buf_b + C * stride;
  float* buf_d = buf_c + C * stride;

  const int r2 = (k - 1) / 2, r1 = d * (k - 1) / 2;
  // position ranges, relative to t0, each stage is computed over
  const int s2_lo = -r2, s2_len = tt + 2 * r2;
  const int c1_lo = s2_lo - 6, c1_len = s2_len + 12;
  const int s1_lo = c1_lo - r1, s1_len = c1_len + 2 * r1;
  const int x_lo = s1_lo - 6, x_len = s1_len + 12;

  const int t0 = blockIdx.x * tt;
  const long long batch_off = (long long)blockIdx.y * C * len;
  const T* xb = static_cast<const T*>(p.x) + batch_off;
  T* outb = static_cast<T*>(p.out) + batch_off;

  // folded kernels, torch (O, I, K) -> [tap][in][out]; parameters
  for (int idx = threadIdx.x; idx < k * C * CP; idx += kAmpThreads) {
    const int m = idx / (C * CP), rem = idx - m * C * CP;
    const int i = rem / CP, o = rem - i * CP;
    w1s[idx] = o < C ? p.w1[(o * C + i) * k + m] : 0.0f;
    w2s[idx] = o < C ? p.w2[(o * C + i) * k + m] : 0.0f;
  }
  for (int o = threadIdx.x; o < CP; o += kAmpThreads) {
    const bool live = o < C;
    b1s[o] = live ? p.b1[o] : 0.0f;
    b2s[o] = live ? p.b2[o] : 0.0f;
    a1s[o] = live ? expf(p.a1[o]) : 1.0f;
    ib1s[o] = live ? 1.0f / (expf(p.be1[o]) + 1e-9f) : 1.0f;
    a2s[o] = live ? expf(p.a2[o]) : 1.0f;
    ib2s[o] = live ? 1.0f / (expf(p.be2[o]) + 1e-9f) : 1.0f;
  }
  // x over [x_lo, x_lo + x_len), edge-replicated by the clamped index
  for (int idx = threadIdx.x; idx < C * x_len; idx += kAmpThreads) {
    const int c = idx / x_len, l = idx - c * x_len;
    buf_a[c * stride + l] = x_at(xb + (long long)c * len, t0 + x_lo + l, len);
  }
  __syncthreads();

  // s1 = SnakeAlias_1(x), zero outside [0, T)
  snake_stage(buf_a, buf_b, buf_c, buf_d, a1s, ib1s, p.taps, C, stride, s1_lo, s1_len, t0, len);

  // c1 = conv1(s1) over [c1_lo, c1_lo + c1_len); a position outside [0, T)
  // takes c1[0] / c1[T-1]. c1 at index j reads s1 at index j + m d.
  for (int base = 0; base < c1_len; base += 2 * kAmpThreads) {
    const int ja = base + threadIdx.x, jb = ja + kAmpThreads;
    const int lo = -t0 - c1_lo, hi = len - 1 - t0 - c1_lo;  // indices of positions 0, T-1
    const int ra = min(max(min(ja, c1_len - 1), lo), hi);
    const int rb = min(max(min(jb, c1_len - 1), lo), hi);
    float acc_a[CP], acc_b[CP];
    conv_pair<OP>(buf_d, w1s, b1s, C, k, d, stride, ra, rb, acc_a, acc_b);
#pragma unroll
    for (int o = 0; o < CP; ++o) {
      if (o < C) {
        if (ja < c1_len) buf_a[o * stride + ja] = acc_a[o];
        if (jb < c1_len) buf_a[o * stride + jb] = acc_b[o];
      }
    }
  }
  __syncthreads();

  // s2 = SnakeAlias_2(c1), zero outside [0, T)
  snake_stage(buf_a, buf_b, buf_c, buf_d, a2s, ib2s, p.taps, C, stride, s2_lo, s2_len, t0, len);

  // out = x + conv2(s2) over [0, tt); out at index j reads s2 at index j + m
  for (int base = 0; base < tt; base += 2 * kAmpThreads) {
    const int ja = base + threadIdx.x, jb = ja + kAmpThreads;
    float acc_a[CP], acc_b[CP];
    conv_pair<OP>(buf_d, w2s, b2s, C, k, 1, stride, min(ja, tt - 1), min(jb, tt - 1), acc_a,
                  acc_b);
    const bool live_a = ja < tt && t0 + ja < len, live_b = jb < tt && t0 + jb < len;
#pragma unroll
    for (int o = 0; o < CP; ++o) {
      if (o < C) {
        const long long row = (long long)o * len + t0;
        if (live_a) store(outb + row + ja, to_f32(xb[row + ja]) + acc_a[o]);
        if (live_b) store(outb + row + jb, to_f32(xb[row + jb]) + acc_b[o]);
      }
    }
  }
}

template <typename T, int OP>
int launch(const Args& p, int batch, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(amp_iter_kernel<T, OP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.len + p.tt - 1) / p.tt, batch);
  amp_iter_kernel<T, OP><<<grid, kAmpThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& p, int batch, size_t smem, cudaStream_t stream) {
  switch ((p.channels + 3) / 4) {
    case 1: return launch<T, 1>(p, batch, smem, stream);
    case 2: return launch<T, 2>(p, batch, smem, stream);
    case 3: return launch<T, 3>(p, batch, smem, stream);
    case 4: return launch<T, 4>(p, batch, smem, stream);
    case 5: return launch<T, 5>(p, batch, smem, stream);
    case 6: return launch<T, 6>(p, batch, smem, stream);
    case 7: return launch<T, 7>(p, batch, smem, stream);
    default: return launch<T, 8>(p, batch, smem, stream);
  }
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1), C <= 32; w1, w2: device float32 (C, C, k) folded kernels in
// torch's (out, in, tap) order; b1, b2: biases [C]; a1, be1, a2, be2:
// log-scale snake parameters [C], all device float32; taps: host float32[24]
// as ae, ao, de, do; k odd, d >= 1; tile: outputs per block. Launches on
// `stream` and returns cudaGetLastError() (or the error of raising the
// kernel's shared-memory limit).
int amp_iter_forward(const void* x, void* out, const void* w1, const void* b1, const void* a1,
                     const void* be1, const void* w2, const void* b2, const void* a2,
                     const void* be2, const float* taps, int is_bf16, int batch, int channels,
                     int len, int k, int d, int tile, void* stream) {
  if (channels < 1 || channels > kMaxC || k < 1 || k % 2 == 0 || d < 1 || tile < 1 ||
      batch < 1 || batch > 65535 || len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p;
  p.x = x;
  p.out = out;
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.a1 = static_cast<const float*>(a1);
  p.be1 = static_cast<const float*>(be1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.a2 = static_cast<const float*>(a2);
  p.be2 = static_cast<const float*>(be2);
  p.taps = load_taps(taps);
  p.channels = channels;
  p.len = len;
  p.k = k;
  p.d = d;
  p.tt = tile;
  p.stride = tile + 2 * ((k - 1) / 2 + 12 + d * (k - 1) / 2);
  const size_t smem = static_cast<size_t>(smem_bytes(channels, k, d, tile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, batch, smem, s) : dispatch<float>(p, batch, smem, s);
}

const char* amp_iter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
