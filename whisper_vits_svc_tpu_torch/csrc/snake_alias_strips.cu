// Strip-folded launch of the fused anti-aliased SnakeBeta for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_vits_svc_tpu/ops/pallas_snake.py::_snake_strips (_kernel_strips):
// the same function as snake_alias.cu, with each [C, T] row cut into `fold`
// time segments and the launch's rows being (segment, channel) pairs, each
// with its global time offset. On the TPU the fold filled 8-row sublane
// groups; here it is a launch shape: the grid is (segment, channel, batch)
// and each block's 8 warps walk its segment in the direct kernel's 248-output
// warp segments, so the caller decides how many blocks a narrow, long stage
// becomes (the direct kernel always launches one warp per warp segment).
// ops/snake_cuda.py::strip_fold chooses the fold: enough segments to fill
// the card's resident blocks once on short rows, and never more than two
// rounds of a block's warps a segment.
//
// The kernel reads x in place: segment s of a row is [s * seg_len,
// min((s + 1) * seg_len, T)), index arithmetic only, with no gather pass in
// and no transpose pass out. Every position, clamp and edge is taken against
// global coordinates by snake_alias.cuh::snake_segment, the direct kernel's
// own body, so the output is bitwise equal to the direct kernel's: a warp
// segment that a strip boundary cuts writes only its part, and the phases
// and clamps of every output are computed by the same instructions.
//
// Bound: HBM bytes, as the direct kernel (x read once, out written once).

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_alias_strips_kernel(const T* __restrict__ x, T* __restrict__ out,
                          const float* __restrict__ alpha, const float* __restrict__ beta,
                          const Taps taps, int channels, int len, int seg_len) {
  const int c = blockIdx.y;
  const long long row_off = ((long long)blockIdx.z * channels + c) * len;
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);
  const int seg_lo = (int)min((long long)blockIdx.x * seg_len, (long long)len);
  const int seg_hi = (int)min((long long)seg_lo + seg_len, (long long)len);
  // warp segments from the 16-byte-aligned position at or before seg_lo
  const int base = seg_lo - (int)((row_off + seg_lo) % kVec<T>);
  for (int s = base + (threadIdx.x / kLanes) * kSegLen; s < seg_hi; s += kWarps * kSegLen) {
    const int lo = max(s, seg_lo), hi = min(s + kSegLen, seg_hi);
    snake_segment(x + row_off, out + row_off, s, lo, hi, len, a, ib, taps);
  }
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); alpha, beta: device float32 [C]; taps: host float32[24] as
// ae, ao, de, do; fold segments of seg_len samples cover each row
// ((fold - 1) * seg_len < T <= fold * seg_len). Launches on `stream` and
// returns cudaGetLastError().
int snake_alias_strips_forward(const void* x, void* out, const void* alpha, const void* beta,
                               const float* taps, int is_bf16, int batch, int channels, int len,
                               int fold, int seg_len, void* stream) {
  if (fold < 1 || seg_len < 1 || (long long)(fold - 1) * seg_len >= len ||
      (long long)fold * seg_len < len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps t = load_taps(taps);
  const dim3 grid(fold, channels, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  if (is_bf16) {
    snake_alias_strips_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), a, b, t,
        channels, len, seg_len);
  } else {
    snake_alias_strips_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a, b, t, channels, len,
        seg_len);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_strips_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
