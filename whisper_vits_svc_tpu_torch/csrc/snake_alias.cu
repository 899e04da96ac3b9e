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
// Design: the previous body (a 1024-output tile a block through shared
// memory) reached 30% of the bound: bf16 took the time of f32, so instructions, not
// bytes, held it back (about 20 shared loads an output). The body is now
// snake_alias.cuh::snake_segment, shared with the strips kernel: one warp
// makes 248 consecutive outputs of a row, each lane a run of 8 from
// registers. A lane loads its 8 samples of x in 16-byte accesses and takes
// the 6 before them from the lane below by shuffles, so each sample is
// loaded once; it slides the two 6-tap up FIRs over them (unfused, so that
// u and the sine's argument are the plain version's to the bit) and takes
// each phase position's sin once; the 6 E and 5 O phases right of its run
// come from the lane above by 11 shuffles. No shared memory. The edge
// clamps E[p<0] = E[0] and O[p>T-1] = O[T-1] are shuffled from the lane
// that computed E[0] or O[T-1]. The launch is one warp per (row, segment)
// pair, 8 warps a block, so a block holds several short rows (T = 125 at
// the training step's first stage). Segments start 16-byte aligned in
// memory (the first one up to 7 samples before the row), so runs inside the
// row load and store 16 bytes at a time even where the row itself is not
// aligned; runs that cross an edge or an unaligned address go element by
// element. ops/snake_cuda.py::snake_plan computes the same geometry.
// Measured on an H100 (PERF.md): 18.1 us a call at the long stages (43% of
// the bound; the previous body 25.9), 1.36 ms a chunk (39%; previously 1.89).
// What holds it now is instruction issue and latency: sinf is about a
// quarter of the time (snake_probe.py), the unfused up FIR a sixth of the
// instructions. Math is f32 for f32 and bf16 inputs. Built without
// --use_fast_math: sinf's fast form loses accuracy as |a*u| grows, and the
// tolerance against the plain version is f32.

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_alias_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ alpha, const float* __restrict__ beta,
                   const Taps taps, int channels, int len, int n_seg, long long warps) {
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (g >= warps) return;
  const long long row = g / n_seg;
  const int c = (int)(row % channels);
  const long long row_off = row * len;
  const int s = (int)(g - row * n_seg) * kSegLen - (int)(row_off % kVec<T>);
  const int lo = max(s, 0), hi = min(s + kSegLen, len);
  if (lo >= hi) return;
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);
  snake_segment(x + row_off, out + row_off, s, lo, hi, len, a, ib, taps);
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); alpha, beta: device float32 [C]; taps: host float32[24] as
// ae, ao, de, do; n_seg segments of seg_len outputs per row, seg_len the
// kernel's (248), n_seg * seg_len >= T + 16 / element size - 1 (room for the
// first segment's aligned start; ops/snake_cuda.py::snake_plan).
// Launches on `stream` and returns cudaGetLastError().
int snake_alias_forward(const void* x, void* out, const void* alpha, const void* beta,
                        const float* taps, int is_bf16, int batch, int channels, int len,
                        int n_seg, int seg_len, void* stream) {
  const int lead = is_bf16 ? kVec<__nv_bfloat16> - 1 : kVec<float> - 1;
  if (seg_len != kSegLen || n_seg < 1 || (long long)n_seg * seg_len < (long long)len + lead) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps t = load_taps(taps);
  const long long warps = (long long)batch * channels * n_seg;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  if (is_bf16) {
    snake_alias_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), a, b, t,
        channels, len, n_seg, warps);
  } else {
    snake_alias_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a, b, t, channels, len, n_seg,
        warps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
