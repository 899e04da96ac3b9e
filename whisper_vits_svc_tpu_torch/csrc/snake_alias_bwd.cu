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
// Design: the forward's (snake_alias.cuh): one warp per 248-output segment
// of a row, 8 warps a block, a block holding the segments of several short
// rows; each lane makes a run of 8 dx from registers. A lane loads its 8
// samples of x and of dy in 16-byte accesses and takes the 6 before each run
// from the lane below, so u, the down-FIR adjoints dE and dO, one sincosf
// per phase and du are computed once per position; the 6 du_e and 5 du_o
// right of its run come from the lane above by shuffles. The clamp sums are
// fixed combinations of dy[0..2] (onto s_e[0]) and dy[T-3..T-1] (onto
// s_o[T-1]), and the edge-pad adjoints of du_e, du_o at 0..2 and T-3..T-1,
// taken from the values the lane already holds; their coefficients come
// from the host (ops/snake_cuda.py::clamp_taps). dalpha/dbeta in the same
// launch without float atomics: each warp sums its own positions (a fixed
// shuffle tree) into its slot of a [B * C * segments] buffer, fences, and
// takes an integer ticket of its channel; the warp that takes the last
// ticket sums that channel's slots in slot order, writes dalpha[c] and
// dbeta[c] and sets the ticket back to 0 for the next call. Two runs give
// bitwise-equal gradients. Measured on an H100 (PERF.md): 1.69 ms a
// training step (19% of the bound; the previous two launches 1.92), 12.1 us
// at the first stage (previously 21.2) but ~21 us from 1.28 M elements on,
// as before.
// Neither bytes nor occupancy hold it (more resident blocks gained 2%,
// snake_probe.py); each warp's long chain does, sincosf about a sixth of
// it. Math is f32 for f32 and bf16 inputs. Built without --use_fast_math,
// as the forward: sincosf's fast form loses accuracy as |a*u| grows.

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

// the taps and the clamp coefficients: hd[k], td[k] weigh dy[k] and
// dy[T-3+k] in the sums onto s_e[0] and s_o[T-1]; hxe/hxo[k] weigh du_e/du_o
// at k, and txe/txo[k] at T-3+k, in the edge-pad adjoints onto dx[0] and dx[T-1]
struct BwdTaps {
  float ae[kTaps], ao[kTaps], de[kTaps], dodd[kTaps];
  float hd[3], td[3], hxe[3], hxo[3], txe[3], txo[3];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_alias_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part_a, float* __restrict__ part_b,
                       int* __restrict__ ticket, const float* __restrict__ alpha,
                       const float* __restrict__ beta, float* __restrict__ dalpha,
                       float* __restrict__ dbeta, const BwdTaps taps, int batch, int channels,
                       int len, int n_seg) {
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (g >= (long long)batch * channels * n_seg) return;
  const int lane = threadIdx.x & (kLanes - 1);
  const long long row = g / n_seg;
  const int c = (int)(row % channels);
  const long long row_off = row * len;
  const int s = (int)(g - row * n_seg) * kSegLen - (int)(row_off % kVec<T>);
  const int lo = max(s, 0), hi = min(s + kSegLen, len);
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);

  float sum_a = 0.0f, sum_b = 0.0f;
  if (lo < hi) {
    const int q0 = s + lane * kRun;  // this lane's first dx
    const int p0 = q0 - 3;           // and first phase position
    float xe[kRun + 6], ye[kRun + 6];  // x, dy at p0 - 3 + i
    stage_run<false>(x + row_off, q0, len, lane, xe);
    stage_run<true>(dy + row_off, q0, len, lane, ye);

    // phases at p = p0 + j: x[p - 3 + m] is xe[j + m], x[p - 2 + m] is
    // xe[j + 1 + m], dy[p + 2 - m] is ye[j + 5 - m], dy[p + 3 - m] is ye[j + 6 - m]
    float du_e[kRun + 6], du_o[kRun + 5];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int p = p0 + j;
      float ue, uo;
      up_fir(taps, xe, j, ue, uo);
      float dse = taps.de[0] * ye[j + 5];
      float dso = taps.dodd[0] * ye[j + 6];
#pragma unroll
      for (int m = 1; m < kTaps; ++m) {
        dse = dse + taps.de[m] * ye[j + 5 - m];
        dso = dso + taps.dodd[m] * ye[j + 6 - m];
      }
      // the clamp sums: positions -3..-1 onto s_e[0], T..T+2 onto s_o[T-1]
      if (p == 0) dse = dse + (taps.hd[0] * ye[j + 3] + taps.hd[1] * ye[j + 4] +
                               taps.hd[2] * ye[j + 5]);
      if (p == len - 1) dso = dso + (taps.td[0] * ye[j + 1] + taps.td[1] * ye[j + 2] +
                                     taps.td[2] * ye[j + 3]);
      float sqe, s2e, sqo, s2o;  // sin^2(a u), sin(2 a u)
      sin_sq_sin2(a * ue, sqe, s2e);
      sin_sq_sin2(a * uo, sqo, s2o);
      const bool live = p >= 0 && p < len;
      du_e[j] = live ? dse * (1.0f + ib * a * s2e) : 0.0f;
      du_o[j] = live ? dso * (1.0f + ib * a * s2o) : 0.0f;
      if (live && p >= s && p < s + kSegLen) {  // each position counted by one warp
        sum_a = sum_a + (dse * ue * s2e + dso * uo * s2o);
        sum_b = sum_b + (dse * sqe + dso * sqo);
      }
    }
    halo_from_next(du_e, du_o);

    // dx[t], t = q0 + i: du_e[t + 3 - m] is du_e[i + 6 - m], du_o[t + 2 - m] is du_o[i + 5 - m]
    float dxv[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      float acc = taps.ae[0] * du_e[i + 6] + taps.ao[0] * du_o[i + 5];
#pragma unroll
      for (int m = 1; m < kTaps; ++m) {
        acc = acc + taps.ae[m] * du_e[i + 6 - m];
        acc = acc + taps.ao[m] * du_o[i + 5 - m];
      }
      const int t = q0 + i;
      if (t == 0) {  // du at positions 0..2 are du_e/du_o[i + 3 ..]
        acc = acc + (taps.hxe[0] * du_e[i + 3] + taps.hxe[1] * du_e[i + 4] +
                     taps.hxe[2] * du_e[i + 5] + taps.hxo[0] * du_o[i + 3] +
                     taps.hxo[1] * du_o[i + 4] + taps.hxo[2] * du_o[i + 5]);
      }
      if (t == len - 1) {  // du at positions T-3..T-1 are du_e/du_o[i + 1 ..]
        acc = acc + (taps.txe[0] * du_e[i + 1] + taps.txe[1] * du_e[i + 2] +
                     taps.txe[2] * du_e[i + 3] + taps.txo[0] * du_o[i + 1] +
                     taps.txo[1] * du_o[i + 2] + taps.txo[2] * du_o[i + 3]);
      }
      dxv[i] = acc;
    }
    if (lane < kLanes - 1) store_run(dx + row_off, q0, lo, hi, dxv);
  }

  // dalpha/dbeta: this warp's slot, then the channel's last warp sums the
  // channel's slots (b, segment) in order
  sum_a = warp_sum(sum_a);
  sum_b = warp_sum(sum_b);
  const int per_channel = batch * n_seg;
  int last = 0;
  if (lane == 0) {
    part_a[g] = sum_a;
    part_b[g] = sum_b;
    __threadfence();
    last = atomicAdd(ticket + c, 1) == per_channel - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  float ta = 0.0f, tb = 0.0f;
  for (int i = lane; i < per_channel; i += kLanes) {
    const int b = i / n_seg;
    const long long slot = ((long long)b * channels + c) * n_seg + (i - b * n_seg);
    ta = ta + __ldcg(part_a + slot);
    tb = tb + __ldcg(part_b + slot);
  }
  ta = warp_sum(ta);
  tb = warp_sum(tb);
  if (lane == 0) {
    const float eb = expf(beta[c]);
    dalpha[c] = a * ib * ta;
    dbeta[c] = -eb * ib * ib * tb;
    ticket[c] = 0;
  }
}

}  // namespace

extern "C" {

// x, dy, dx: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); part_a, part_b: device float32 [B * C * n_seg] scratch;
// ticket: device int32 [C], all 0 (the kernel leaves them 0); alpha, beta,
// dalpha, dbeta: device float32 [C]; taps: host float32[42] as ae, ao, de,
// do, hd, td, hxe, hxo, txe, txo; n_seg segments of seg_len outputs per row,
// as the forward takes them. One launch on `stream`; returns
// cudaGetLastError().
int snake_alias_backward(const void* x, const void* dy, void* dx, void* part_a, void* part_b,
                         void* ticket, const void* alpha, const void* beta, void* dalpha,
                         void* dbeta, const float* taps, int is_bf16, int batch, int channels,
                         int len, int n_seg, int seg_len, void* stream) {
  const int lead = is_bf16 ? kVec<__nv_bfloat16> - 1 : kVec<float> - 1;
  if (seg_len != kSegLen || n_seg < 1 || (long long)n_seg * seg_len < (long long)len + lead ||
      (long long)batch * n_seg >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdTaps t;
  float* fields[10] = {t.ae, t.ao, t.de, t.dodd, t.hd, t.td, t.hxe, t.hxo, t.txe, t.txo};
  for (int f = 0, at = 0; f < 10; ++f) {
    const int n = f < 4 ? kTaps : 3;
    for (int m = 0; m < n; ++m) fields[f][m] = taps[at++];
  }
  const long long warps = (long long)batch * channels * n_seg;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  float* pa = static_cast<float*>(part_a);
  float* pb = static_cast<float*>(part_b);
  int* tk = static_cast<int*>(ticket);
  float* da = static_cast<float*>(dalpha);
  float* db = static_cast<float*>(dbeta);
  if (is_bf16) {
    snake_alias_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), pa, pb, tk, a, b, da, db, t, batch, channels, len,
        n_seg);
  } else {
    snake_alias_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx),
        pa, pb, tk, a, b, da, db, t, batch, channels, len, n_seg);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
