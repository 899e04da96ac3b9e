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
// Bound: the channel mixes, 4 k C operations an element against 116 for
// both snakes (8 B moved an element in f32). On the CUDA cores that is 48.5
// us at [20, 163200], k = 11 (67 TFLOP/s); as 3xTF32 on the tensor cores
// (495 TFLOP/s dense, three products) 17.4 us, plus 5.6 us of snakes.
//
// Design. One block of 8 warps per (batch, time tile of tt outputs), all C
// <= 32 channels. A tile needs s2 over [-r2, tt + r2), c1 over 6 more a
// side, s1 over r1 more, x over 6 (8 for alignment) more. Shared memory
// holds two regions, each channel-major: R1 (f32) is x, then c1; R2 (hi and
// lo as float2) is s1, then s2; and up to 18 k-steps of one conv's weight
// fragments. At C = 20, tt = 208, k = 11, d = 5 that is 103 KB, so two
// blocks share an SM (the previous form kept four [C, tile] buffers and
// both kernels, 216 KB, one block). ops/amp_cuda.py::amp_tile sizes tt so
// that the grid fills whole waves of two blocks an SM and each warp holds
// its m-tiles in one round.
//
// Snakes: a warp makes 248 outputs of one channel as the direct kernel does
// (snake_alias.cuh::snake_phases: 8 positions a lane, the 6 inputs before a
// run and the phases after it by shuffles, unfused up FIR), reading its run
// from R1 in 16-byte loads: no branch per element. Each lane zeroes its
// outputs outside [0, T), splits them into TF32 hi and lo once, and writes
// them to R2.
//
// Channel mixes on the tensor cores: m16n8k8 TF32 products with M = 16
// time positions, N = output channels (8 a tile: 3 tiles at C = 20, 2 at
// C = 10) and K = the k C (tap, input channel) pairs, kk = m C + i, in
// k-steps of 8 (14 at C = 10, k = 11, where a k-step per tap and 8
// channels would take 22); A = s[i][pos + m step], B = the folded kernels.
// Each product is three mma (lo x hi, hi x lo, hi x hi) for f32 accuracy,
// and each group of 3 k-steps is summed into fresh accumulators that are
// then added in f32 (the tensor cores truncate as they accumulate: one
// chain over all k-steps missed the f32 tolerance on the card at k = 11).
// The folded kernels are split into hi and lo once per launch by a first,
// small kernel into fragment order; a block stages them in shared memory,
// up to 18 k-steps at a time, one 16-byte load a lane for each k-step and
// n-tile, used for the warp's 2 (C > 16) or 4 m-tiles. s's split was made
// when it was written: an A fragment is four 8-byte loads. Rows of R2 are 4
// (mod 16) float2 apart, so those loads are free of bank conflicts. Rows
// past k C read channel C - 1 (finite) against zero weights.
//
// What holds it (PERF.md, tc_probe.py): the mixes, whose mma.sync run far
// below the card's TF32 rate (3xTF32, padding to 8-channel tiles, 16 warps
// an SM), and the snake stages, whose warps run B1's long per-lane chains
// between block barriers. The per-tile cost hardly shrinks with the tile,
// so the largest tile that keeps two blocks an SM is the fastest. (N =
// positions, M = output channels took the same time per chunk: 6-13%
// faster at C = 10, up to 12% slower at C = 20.)
//
// Edges are index clamps against global positions: x is loaded clamped;
// c1 outside [0, T) is set to c1[0] / c1[T-1] in the tiles that reach an
// edge; s1 and s2 are zeroed outside [0, T). Every tile is self-contained
// and any T >= 1 runs. The base-width shapes (C = 10, 20; k = 3, 7, 11;
// d = 1, 3, 5) are compile-time instances; other C <= 32 take a generic
// instance of the same kernel.

#include <cstdint>

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

constexpr int kAmpThreads = 256;
constexpr int kAmpWarps = kAmpThreads / kLanes;
constexpr int kMaxC = 32;
// the mixes' K packs (tap, input channel) pairs, kk = m C + i, into
// k-steps of 8; a block stages at most this many k-steps of a conv's
// fragments at once, and sums each group of kGroup k-steps on its own
constexpr int kMaxStagedKsteps = 18;
constexpr int kGroup = 3;

// k-steps of one conv's K = k C, and of them what a block stages at once
__host__ __device__ inline int ksteps(int channels, int k) { return (k * channels + 7) / 8; }
__host__ __device__ inline int ksteps_staged(int channels, int k) {
  const int n = ksteps(channels, k);
  return n < kMaxStagedKsteps ? n : kMaxStagedKsteps;
}

// row strides (R1 in floats, = 8 mod 32; R2 in float2, = 4 mod 16) and the
// lengths each stage is computed over, for a tile of tt outputs
struct Geometry {
  int r1, r2;
  int l2, lc, l1;       // s2, c1 and s1 positions
  int s1_lo, s2_lo;     // first s1 and s2 position, relative to t0
  int e1;               // s1 positions before the first one conv1 reads
  int lr1, ls2;         // row strides
};

__host__ __device__ inline int round_to(int v, int mod, int rem) {
  // the least w >= v with w = rem (mod `mod`)
  return v + ((rem - v) % mod + mod) % mod;
}

__host__ __device__ inline Geometry geometry(int k, int d, int tt) {
  Geometry g;
  g.r2 = (k - 1) / 2;
  g.r1 = d * (k - 1) / 2;
  g.l2 = tt + 2 * g.r2;
  g.lc = g.l2 + 12;
  g.s2_lo = -g.r2;
  // s1 from a multiple of 8 (x then loads 16 bytes at a time from t0 + s1_lo - 8)
  const int want = g.s2_lo - 6 - g.r1;
  g.s1_lo = -8 * ((7 - want) / 8);
  g.e1 = want - g.s1_lo;
  g.l1 = g.e1 + g.lc + 2 * g.r1;
  // a snake lane reads its input from (its first output) + 2 to + 15; the
  // lanes up to 5 outputs past the stage feed its last outputs
  g.lr1 = round_to(8 * ((g.l1 + 21 + 7) / 8), 32, 8);
  g.ls2 = round_to(8 * ((g.l1 + 7) / 8) + 16, 16, 4);  // m-tiles read to l1 + 15
  return g;
}

long long smem_bytes(int channels, int k, int d, int tt) {
  const Geometry g = geometry(k, d, tt);
  const long long frags = (long long)kLanes * ((channels + 7) / 8);  // float4 a k-step
  return (long long)channels * (4LL * g.lr1 + 8LL * g.ls2) +
         16LL * ksteps_staged(channels, k) * frags;
}

struct Args {
  const void* x;
  void* out;
  const float4* wfrag;  // [conv][m][ks][mt][hi, lo][lane]
  const float *b1, *a1, *be1, *b2, *a2, *be2;
  Taps taps;
  int channels, len, k, d, tt, is_bf16;
};

template <typename T>
__device__ __forceinline__ const T* typed(const void* p) { return static_cast<const T*>(p); }

// One snake stage: outputs [0, L) (position t0 + lo + i) of every channel
// from `in` (index i <-> position t0 + lo - 8 + i, rows lr1 apart, inputs
// already clamped to the row), zeroed outside [0, len), split into hi / lo
// at `dst` (index i <-> position t0 + lo + i, rows ls2 apart).
__device__ __forceinline__ void snake_stage(const float* in, float2* dst, const float* alpha,
                                            const float* beta, const Taps& taps, int channels,
                                            int lr1, int ls2, int lo, int L, int t0, int len) {
  const int lane = threadIdx.x & (kLanes - 1), wid = threadIdx.x / kLanes;
  const int n_seg = (L + kSegLen - 1) / kSegLen;
  for (int task = wid; task < channels * n_seg; task += kAmpWarps) {
    const int c = task / n_seg, sigma = task - c * n_seg;
    const int i0 = sigma * kSegLen + lane * kRun;  // this lane's first output
    const float* row = in + c * lr1;
    float own[kRun];
    if (i0 + 16 <= lr1) {
      load_vec(row + i0 + 8, own);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) own[i] = 0.0f;  // feeds only outputs past L
    }
    float xe[kRun + 6];
#pragma unroll
    for (int i = 0; i < kRun; ++i) xe[6 + i] = own[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float v = __shfl_up_sync(kFull, own[kRun - 6 + i], 1);
      if (lane == 0) v = row[i0 + 2 + i];
      xe[i] = v;
    }
    const float a = expf(alpha[c]);
    const float ib = 1.0f / (expf(beta[c]) + 1e-9f);
    const int q0 = t0 + lo + i0;  // global position of the first output
    float ph_e[kRun + 6], ph_o[kRun + 5];
    snake_phases(taps, xe, q0 - 3, t0 + lo + sigma * kSegLen - 3, len, a, ib, ph_e, ph_o);
    halo_from_next(ph_e, ph_o);
    float y[kRun];
    down_fir(taps, ph_e, ph_o, y);
    if (lane < kLanes - 1 && i0 < L) {
      float4* d4 = reinterpret_cast<float4*>(dst + c * ls2 + i0);
#pragma unroll
      for (int i = 0; i < kRun; i += 2) {
        float v0 = y[i], v1 = y[i + 1];
        v0 = (q0 + i >= 0 && q0 + i < len) ? v0 : 0.0f;
        v1 = (q0 + i + 1 >= 0 && q0 + i + 1 < len) ? v1 : 0.0f;
        float h0, l0, h1, l1;
        tf32_split(v0, h0, l0);
        tf32_split(v1, h1, l1);
        d4[i / 2] = make_float4(h0, l0, h1, l1);
      }
    }
  }
}

// One channel mix over m-tiles [0, m_tiles) of 16 positions: for position
// j, acc[o][j] = bias[o] + sum_m W_m[o][:] . src[:][j + m step], with K =
// k C packed as kk = m C + i in k-steps of 8 (the last one padded with zero
// weights) and N = the output channels in NT n-tiles of 8. Each warp takes a
// contiguous run of the m-tiles, MTW at a time; all warps walk the same
// number of rounds, since each round stages the conv's fragments (`wfrag`,
// global) into `wsm`, up to kMaxStagedKsteps k-steps between block
// barriers. Each group of kGroup k-steps is summed into fresh accumulators
// and then added in f32: the tensor cores truncate as they accumulate, and
// over 3 kGroup mma that stays near an ulp, where over all 3 K / 8 it grows
// past the f32 tolerance. `emit` gets (o, j, value) for o < channels.
template <int NT, int MTW, typename Emit>
__device__ __forceinline__ void channel_mix(const float2* src, const float4* __restrict__ wfrag,
                                            float4* wsm, const float* bias, int channels, int k,
                                            int step, int ls2, int m_tiles, Emit emit) {
  constexpr int kStepFrags = NT * kLanes;  // float4 a k-step: [nt][lane]
  const int lane = threadIdx.x & (kLanes - 1), wid = threadIdx.x / kLanes;
  const int gid = lane >> 2, tig = lane & 3;
  const int per = (m_tiles + kAmpWarps - 1) / kAmpWarps;
  const int first = wid * per, last = min(first + per, m_tiles);
  const int rounds = (per + MTW - 1) / MTW;
  const int kc = k * channels, nks = ksteps(channels, k);
  float bv[NT][2];  // the bias of output channels 8 nt + 2 tig and + 1
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 8 * nt + 2 * tig + h;
      bv[nt][h] = o < channels ? bias[o] : 0.0f;
    }
  }
  for (int round = 0; round < rounds; ++round) {
    const int m0 = first + round * MTW;
    const int cnt = min(MTW, last - m0);  // may be <= 0: the warp only stages
    float acc[MTW][NT][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] = acc[mt][nt][2] = bv[nt][0];
        acc[mt][nt][1] = acc[mt][nt][3] = bv[nt][1];
      }
    }
    for (int s0 = 0; s0 < nks; s0 += kMaxStagedKsteps) {
      const int len = min(kMaxStagedKsteps, nks - s0);
      if (round == 0 || nks > kMaxStagedKsteps) {
        __syncthreads();  // every warp is done with the chunk before
        for (int i = threadIdx.x; i < len * kStepFrags; i += kAmpThreads) {
          wsm[i] = wfrag[s0 * kStepFrags + i];
        }
        __syncthreads();
      }
#pragma unroll 1
      for (int g0 = 0; g0 < len; g0 += kGroup) {
        float part[MTW][NT][4];
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            part[mt][nt][0] = part[mt][nt][1] = part[mt][nt][2] = part[mt][nt][3] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (g0 + u < len) {
            uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float4 w = wsm[((g0 + u) * NT + nt) * kLanes + lane];
              b_hi[nt][0] = __float_as_uint(w.x), b_hi[nt][1] = __float_as_uint(w.y);
              b_lo[nt][0] = __float_as_uint(w.z), b_lo[nt][1] = __float_as_uint(w.w);
            }
            // A columns kk = 8 ks + tig and + 4: input channel kk % C of tap kk / C
            const int ka = 8 * (s0 + g0 + u) + tig, kb = ka + 4;
            const int ma = ka / channels, mb = kb / channels;
            const int oa = ka < kc ? (ka - ma * channels) * ls2 + ma * step : (channels - 1) * ls2;
            const int ob = kb < kc ? (kb - mb * channels) * ls2 + mb * step : (channels - 1) * ls2;
#pragma unroll
            for (int mt = 0; mt < MTW; ++mt) {
              if (mt < cnt) {
                const float2* base = src + 16 * (m0 + mt) + gid;
                const float2 x0 = base[oa], x1 = base[oa + 8], x2 = base[ob], x3 = base[ob + 8];
                const uint32_t a_hi[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                          __float_as_uint(x2.x), __float_as_uint(x3.x)};
                const uint32_t a_lo[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y),
                                          __float_as_uint(x2.y), __float_as_uint(x3.y)};
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  mma_3xtf32(part[mt][nt], a_hi, a_lo, b_hi[nt], b_lo[nt]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
          }
        }
      }
    }
    // C fragment: (position gid, channel 8 nt + 2 tig) and the channel after
    // it, then the same 8 positions on
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      if (mt < cnt) {
        const int j = 16 * (m0 + mt) + gid;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = 8 * nt + 2 * tig + (e & 1);
            if (o < channels) emit(o, j + 8 * (e >> 1), acc[mt][nt][e]);
          }
        }
      }
    }
  }
}

// CC, KK, DD: channels, taps and dilation fixed at compile time, or 0 for
// the launch's own
template <int NT, int CC, int KK, int DD>
__global__ void __launch_bounds__(kAmpThreads, 2) amp_iter_kernel(const Args p) {
  // m-tiles a warp holds: group and running sums, MTW x NT x 8 registers
  constexpr int MTW = NT <= 2 ? 4 : 2;
  extern __shared__ float4 smem4[];
  const int C = CC ? CC : p.channels, k = KK ? KK : p.k, d = DD ? DD : p.d;
  const int len = p.len, tt = p.tt;
  const Geometry g = geometry(k, d, tt);
  float* r1 = reinterpret_cast<float*>(smem4);                 // [C][lr1]
  float2* r2 = reinterpret_cast<float2*>(r1 + C * g.lr1);      // [C][ls2]
  float4* wsm = reinterpret_cast<float4*>(r2 + C * g.ls2);     // staged fragments

  const int t0 = blockIdx.x * tt;
  const long long batch_off = (long long)blockIdx.y * C * len;

  // x over positions t0 + s1_lo - 8 + i, clamped to the row; past the
  // loaded part (the lanes that feed only dropped outputs) zero
  const int x0 = t0 + g.s1_lo - 8;
  const int x_chunks = (g.l1 + 14 + 7) / 8;  // what the outputs read: index l1 + 13
  for (int idx = threadIdx.x; idx < C * (g.lr1 / 8); idx += kAmpThreads) {
    const int c = idx / (g.lr1 / 8), j = idx - c * (g.lr1 / 8);
    float v[kRun];
    if (j < x_chunks) {
      if (p.is_bf16) {
        load_run<false>(typed<__nv_bfloat16>(p.x) + batch_off + (long long)c * len, x0 + 8 * j,
                        len, v);
      } else {
        load_run<false>(typed<float>(p.x) + batch_off + (long long)c * len, x0 + 8 * j, len, v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) v[i] = 0.0f;
    }
    store_vec(r1 + c * g.lr1 + 8 * j, v);
  }
  __syncthreads();

  // s1 = SnakeAlias_1(x) over [s1_lo, s1_lo + l1), zero outside [0, T)
  snake_stage(r1, r2, p.a1, p.be1, p.taps, C, g.lr1, g.ls2, g.s1_lo, g.l1, t0, len);
  __syncthreads();

  // c1 = conv1(s1) over [s2_lo - 6, + lc) into R1: c1 at index j (position
  // t0 + s2_lo - 6 + j) reads s1 at index e1 + j + m d; it goes to R1 index j + 2
  {
    const int lc = g.lc, lr1 = g.lr1;
    channel_mix<NT, MTW>(r2 + g.e1, p.wfrag, wsm, p.b1, C, k, d, g.ls2, (lc + 15) / 16,
                         [&](int o, int j, float v) {
                           if (j < lc) r1[o * lr1 + j + 2] = v;
                         });
  }
  __syncthreads();
  // c1 outside [0, T) takes c1[0] / c1[T-1] (the second snake's edge)
  const int c1_pos0 = t0 + g.s2_lo - 6;
  if (c1_pos0 < 0 || c1_pos0 + g.lc > len) {
    for (int idx = threadIdx.x; idx < C * g.lc; idx += kAmpThreads) {
      const int c = idx / g.lc, j = idx - c * g.lc;
      const int pos = c1_pos0 + j;
      if (pos < 0 || pos > len - 1) {
        const int src = min(max(pos, 0), len - 1) - c1_pos0;
        r1[c * g.lr1 + j + 2] = r1[c * g.lr1 + src + 2];
      }
    }
    __syncthreads();
  }

  // s2 = SnakeAlias_2(c1) over [s2_lo, s2_lo + l2), zero outside [0, T)
  snake_stage(r1, r2, p.a2, p.be2, p.taps, C, g.lr1, g.ls2, g.s2_lo, g.l2, t0, len);
  __syncthreads();

  // out = x + conv2(s2) over [0, tt): out at j reads s2 at index j + m
  const float4* w2 = p.wfrag + ksteps(C, k) * NT * kLanes;  // the second conv's
  const int lim = min(tt, len - t0);
  if (p.is_bf16) {
    const __nv_bfloat16* xb = typed<__nv_bfloat16>(p.x) + batch_off + t0;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) + batch_off + t0;
    channel_mix<NT, MTW>(r2, w2, wsm, p.b2, C, k, 1, g.ls2, (tt + 15) / 16,
                         [&](int o, int j, float v) {
                           const long long at = (long long)o * len + j;
                           if (j < lim) store(ob + at, to_f32(xb[at]) + v);
                         });
  } else {
    const float* xf = typed<float>(p.x) + batch_off + t0;
    float* of = static_cast<float*>(p.out) + batch_off + t0;
    channel_mix<NT, MTW>(r2, w2, wsm, p.b2, C, k, 1, g.ls2, (tt + 15) / 16,
                         [&](int o, int j, float v) {
                           const long long at = (long long)o * len + j;
                           if (j < lim) of[at] = xf[at] + v;
                         });
  }
}

// The folded kernels (torch (O, I, K), two of them) as mma B fragments:
// wfrag[conv][ks][nt][lane] = (hi of b0, hi of b1, lo of b0, lo of b1) with
// b0 = W[o][kk], b1 = W[o][kk + 4], o = 8 nt + lane / 4, kk = 8 ks + lane % 4,
// and W[o][kk] = W_m[o][i] for kk = m C + i: zero past C outputs and k C.
__global__ void amp_iter_prep_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                     float4* __restrict__ wfrag, int channels, int k, int nt_n) {
  const int per_conv = ksteps(channels, k) * nt_n * kLanes;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < 2 * per_conv;
       idx += gridDim.x * blockDim.x) {
    const int conv = idx / per_conv;
    int rem = idx - conv * per_conv;
    const int lane = rem % kLanes;
    rem /= kLanes;
    const int nt = rem % nt_n, ks = rem / nt_n;
    const float* w = conv ? w2 : w1;
    const int o = 8 * nt + (lane >> 2), kk = 8 * ks + (lane & 3);
    float hi[2], lo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kke = kk + 4 * e, m = kke / channels, i = kke - m * channels;
      const float v = (o < channels && kke < k * channels)
                          ? w[((long long)o * channels + i) * k + m] : 0.0f;
      tf32_split(v, hi[e], lo[e]);
    }
    wfrag[idx] = make_float4(hi[0], hi[1], lo[0], lo[1]);
  }
}

template <int NT, int CC, int KK, int DD>
int launch(const Args& p, int batch, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(amp_iter_kernel<NT, CC, KK, DD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.len + p.tt - 1) / p.tt, batch);
  amp_iter_kernel<NT, CC, KK, DD><<<grid, kAmpThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the base-width (C, k, d) at compile time, or the generic instance for C
template <int NT, int CC>
int launch_kd(const Args& p, int batch, size_t smem, cudaStream_t stream) {
#define AMP_KD(K, D) \
  if (p.k == K && p.d == D) return launch<NT, CC, K, D>(p, batch, smem, stream);
  AMP_KD(3, 1) AMP_KD(3, 3) AMP_KD(3, 5)
  AMP_KD(7, 1) AMP_KD(7, 3) AMP_KD(7, 5)
  AMP_KD(11, 1) AMP_KD(11, 3) AMP_KD(11, 5)
#undef AMP_KD
  return launch<NT, 0, 0, 0>(p, batch, smem, stream);
}

int dispatch(const Args& p, int batch, size_t smem, cudaStream_t stream) {
  if (p.channels == 10) return launch_kd<2, 10>(p, batch, smem, stream);
  if (p.channels == 20) return launch_kd<3, 20>(p, batch, smem, stream);
  switch ((p.channels + 7) / 8) {
    case 1: return launch<1, 0, 0, 0>(p, batch, smem, stream);
    case 2: return launch<2, 0, 0, 0>(p, batch, smem, stream);
    case 3: return launch<3, 0, 0, 0>(p, batch, smem, stream);
    default: return launch<4, 0, 0, 0>(p, batch, smem, stream);
  }
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1), C <= 32; w1, w2: device float32 (C, C, k) folded kernels in
// torch's (out, in, tap) order; b1, b2: biases [C]; a1, be1, a2, be2:
// log-scale snake parameters [C], all device float32; wfrag: device float32
// scratch of 2 ceil(k C / 8) ceil(C / 8) 128 floats
// (ops/amp_cuda.py::wfrag_floats); taps: host float32[24] as ae, ao, de,
// do; k odd, d >= 1; tile: outputs per block, a multiple of 8
// (ops/amp_cuda.py::amp_tile). Launches two kernels on `stream` (the
// weights' split, then the iteration) and returns cudaGetLastError() (or
// the error of raising the kernel's shared-memory limit).
int amp_iter_forward(const void* x, void* out, const void* w1, const void* b1, const void* a1,
                     const void* be1, const void* w2, const void* b2, const void* a2,
                     const void* be2, void* wfrag, const float* taps, int is_bf16, int batch,
                     int channels, int len, int k, int d, int tile, void* stream) {
  if (channels < 1 || channels > kMaxC || k < 1 || k % 2 == 0 || d < 1 || tile < 8 ||
      tile % 8 != 0 || batch < 1 || batch > 65535 || len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (channels + 7) / 8;
  const int frags = 2 * ksteps(channels, k) * nt * kLanes;
  amp_iter_prep_kernel<<<(frags + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float4*>(wfrag), channels, k, nt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p;
  p.x = x;
  p.out = out;
  p.wfrag = static_cast<const float4*>(wfrag);
  p.b1 = static_cast<const float*>(b1);
  p.a1 = static_cast<const float*>(a1);
  p.be1 = static_cast<const float*>(be1);
  p.b2 = static_cast<const float*>(b2);
  p.a2 = static_cast<const float*>(a2);
  p.be2 = static_cast<const float*>(be2);
  p.taps = load_taps(taps);
  p.channels = channels;
  p.len = len;
  p.k = k;
  p.d = d;
  p.tt = tile;
  p.is_bf16 = is_bf16;
  return dispatch(p, batch, static_cast<size_t>(smem_bytes(channels, k, d, tile)), s);
}

const char* amp_iter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
