// The Viterbi trellis of CREPE's pitch decode, n frames in one launch of
// one block, for Hopper (sm_90a).
//
// Replaces the JAX package's lax.scan whisper_vits_svc_tpu/models/crepe.py::
// _viterbi_trellis (:148), which has no Pallas kernel; in the port it takes
// the place of the stream's float32 numpy loop (infer/stream_extract.py) and
// of the offline decode's torch loop on the card (models/crepe.py). For each
// frame t and destination bin `to`, over all 360 sources `from`:
//   score[from] = value[from] + log_trans[from, to]       (one float32 add)
//   ptr[t, to]  = the first `from` of the largest score    (numpy's and torch's argmax)
//   value'[to]  = that score + obs[t, to]                  (one float32 add)
// Every score is the plain version's float32 add, every maximum an exact
// comparison, so values and pointers are bitwise equal to it
// (ops/viterbi_cuda.py::viterbi_trellis_plain).
//
// Bound: latency. The frames are a serial recursion, so n frames take n
// dependent steps on one SM whatever the card's width. A step's floor is a
// first-index maximum over 360 scores, 9 levels of shuffle and compare, and
// one exchange of the values across the block's warps (a barrier), plus the
// launch; the bytes (a frame's 1,440 B in, 720 B of pointers out) are
// loaded a frame ahead and take ~0.6 ns a frame at HBM's rate.
// chip_smoke.py measures those latencies on the card and gives the bound.
//
// Design. The transition matrix is banded: every entry with |from - to| > R
// (R = 11) is one float32 number, `far` (log(1e-30)); the others form a
// [360, 23] band (ops/viterbi_cuda.py::banded checks this on the matrix it
// is given, bit for bit). So an out-of-band score value[from] + far does not
// depend on `to`: each is computed once a frame, S[from], the same float32
// add. For `to`, the sources fall in index order into [0, to - R) (out of
// band), the band [to - R, to + R] and (to + R, 360) (out of band). Each
// frame the block forms the prefix maxima of S with their first index (P[k]
// over S[0..k]) and the suffix maxima (Q[k] over S[k..359]) by warp shuffles
// and a pass over the 12 warps' totals; thread `to` then takes P[to - R - 1],
// its 23 band scores in increasing `from`, then Q[to + R + 1], each only
// when strictly larger than what it holds. Merging (score, index) pairs in
// index order with the lower index winning ties gives the first index of
// the maximum over all 360 scores. No score is skipped: every out-of-band
// one is computed and compared (where the band's sources are masked bins,
// a far source wins), in ~8,640 adds a frame instead of 129,600.
//
// One block of 384 threads (12 warps), thread j for bin j (lanes 360-383
// idle but for the scans, where they hold -inf after every bin); each
// thread keeps its 23 band entries in registers; shared memory holds the
// value (two buffers, with -inf guard cells either side), P, Q and the
// warps' totals, 8.9 KB. The warps' totals are scanned with shuffles too, by
// every warp at once. Three barriers a frame. A frame's observation is loaded a frame ahead. The
// pointers go out as int16, the value after the last frame as float32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 360;
constexpr int kRadius = 11;
constexpr int kBand = 2 * kRadius + 1;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// -inf guard cells on both sides of the value, so that the band's sources
// outside [0, 360) score -inf and the band walk needs no bounds test
constexpr int kGuard = kRadius + 1;

struct Best {
  float v;
  int i;
};

// `lo` holds lower source indices than `hi`: `hi` wins only when strictly
// larger, so on equal scores the first index stays.
__device__ __forceinline__ Best pick(Best lo, Best hi) { return hi.v > lo.v ? hi : lo; }

__global__ void __launch_bounds__(kThreads, 1)
viterbi_trellis_kernel(const float* __restrict__ obs, const float* __restrict__ value_in,
                       const float* __restrict__ band, float* __restrict__ value_out,
                       int16_t* __restrict__ ptrs, float far, float init, int n, int first) {
  __shared__ float val[2][kGuard + kBins + kGuard];
  __shared__ Best pre[kBins];
  __shared__ Best suf[kBins];
  __shared__ Best warp_pre[kWarps];
  __shared__ Best warp_suf[kWarps];

  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const bool bin = j < kBins;
  const float neg_inf = -__int_as_float(0x7f800000);

  float b[kBand];
#pragma unroll
  for (int k = 0; k < kBand; ++k) b[k] = bin ? band[j * kBand + k] : 0.f;

  if (j < 2 * kGuard) {
    const int g = j < kGuard ? j : kBins + j;  // [0, kGuard) and [kGuard + kBins, +kGuard)
    val[0][g] = val[1][g] = neg_inf;
  }
  if (bin) val[0][kGuard + j] = first ? obs[j] + init : value_in[j];
  float o_next = bin && first < n ? obs[static_cast<size_t>(first) * kBins + j] : 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = first; t < n; ++t) {
    // this frame's observation was loaded a frame ahead; load the next one
    const float o = o_next;
    if (bin && t + 1 < n) o_next = obs[static_cast<size_t>(t + 1) * kBins + j];

    // S[j] = value[j] + far, then its prefix and suffix maxima in the warp
    const float s = bin ? val[cur][kGuard + j] + far : neg_inf;
    Best p{s, j}, q{s, j};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Best up{__shfl_up_sync(kFull, p.v, d), __shfl_up_sync(kFull, p.i, d)};
      const Best dn{__shfl_down_sync(kFull, q.v, d), __shfl_down_sync(kFull, q.i, d)};
      if (lane >= d) p = pick(up, p);
      if (lane + d < 32) q = pick(q, dn);
    }
    if (lane == 31) warp_pre[warp] = p;
    if (lane == 0) warp_suf[warp] = q;
    __syncthreads();

    // across the warps: lane u holds warp u's totals, scanned as above over
    // the 12 lanes; a warp takes the prefix of the warps below it (lane
    // warp - 1) for P and the suffix of those above (lane warp + 1) for Q
    Best wp{neg_inf, kThreads}, ws{neg_inf, kThreads};
    if (lane < kWarps) {
      wp = warp_pre[lane];
      ws = warp_suf[lane];
    }
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const Best up{__shfl_up_sync(kFull, wp.v, d), __shfl_up_sync(kFull, wp.i, d)};
      const Best dn{__shfl_down_sync(kFull, ws.v, d), __shfl_down_sync(kFull, ws.i, d)};
      if (lane >= d) wp = pick(up, wp);
      if (lane + d < kWarps) ws = pick(ws, dn);
    }
    const Best below{__shfl_sync(kFull, wp.v, warp - 1), __shfl_sync(kFull, wp.i, warp - 1)};
    const Best above{__shfl_sync(kFull, ws.v, warp + 1), __shfl_sync(kFull, ws.i, warp + 1)};
    if (bin) {
      if (warp > 0) p = pick(below, p);
      if (warp < kWarps - 1) q = pick(q, above);
      pre[j] = p;
      suf[j] = q;
    }
    __syncthreads();

    // thread j as `to`: below the band, the band, above it, in index order.
    // With no source below the band, (-inf, 0) stands in: any finite score
    // replaces it, and where every score is -inf, 0 is the first index, as
    // the guard cells' -inf scores never replace anything.
    if (bin) {
      Best best = j > kRadius ? pre[j - kRadius - 1] : Best{neg_inf, 0};
#pragma unroll
      for (int k = 0; k < kBand; ++k)
        best = pick(best, Best{val[cur][kGuard - kRadius + j + k] + b[k], j - kRadius + k});
      if (j + kRadius + 1 < kBins) best = pick(best, suf[j + kRadius + 1]);
      val[cur ^ 1][kGuard + j] = best.v + o;
      ptrs[static_cast<size_t>(t - first) * kBins + j] = static_cast<int16_t>(best.i);
    }
    cur ^= 1;
    __syncthreads();
  }
  if (bin) value_out[j] = val[cur][kGuard + j];
}

}  // namespace

extern "C" {

// obs: device float32 [n, 360] contiguous, the log observations; value_in:
// device float32 [360], the value at the frame before obs[0] (read only when
// first = 0); band: device float32 [360, 23], band[to][k] = log_trans[to - 11
// + k][to] (entries whose source lies outside [0, 360) are not read); far:
// every log_trans entry with |from - to| > 11; init: added to obs[0] when
// first = 1, which starts the trellis there; value_out: device float32 [360],
// the value after the last frame; ptrs: device int16 [n - first, 360], the
// backpointers of frames first .. n-1. n >= 1. Launches one block on
// `stream` and returns cudaGetLastError().
int viterbi_trellis_forward(const void* obs, const void* value_in, const void* band,
                            void* value_out, void* ptrs, float far, float init, int n, int first,
                            void* stream) {
  if (n < 1 || (first != 0 && first != 1)) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_trellis_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), static_cast<const float*>(value_in),
      static_cast<const float*>(band), static_cast<float*>(value_out),
      static_cast<int16_t*>(ptrs), far, init, n, first);
  return static_cast<int>(cudaGetLastError());
}

const char* viterbi_trellis_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
