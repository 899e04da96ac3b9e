// Tensor-core form of the fused anti-aliased SnakeBeta for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_vits_svc_tpu/ops/pallas_snake.py::_kernel_nocopy_mxu (the
// `mxu=True` form of snake_alias_cm_pallas): the same function as
// snake_alias.cu, with the two down-phase FIRs run as one banded matrix
// product on the tensor cores. Up FIRs, snake and clamps are the direct
// kernel's own (snake_alias.cuh::snake_phases).
//
// Work plan: the direct kernel's (ops/snake_cuda.py::snake_plan). One warp
// makes the 248 outputs [s, s + 248) of a (b, c) row; lane l loads x in
// 16-byte accesses and computes E and O at the 8 phase positions
// s - 3 + 8 l + j, so the warp holds the 256 phases s - 3 .. s + 252 that
// its outputs read, each computed once (1.03 phase positions an output; the
// previous tile-based form computed 1.25). The up FIRs stay on the CUDA
// cores, unfused, so that u and the sine's argument a u are the plain
// version's to the bit: at |a u| ~ 1e3 and 1 / e^beta ~ 20 a 3xTF32 up FIR,
// a few ulp off u, misses the f32 tolerance by about 10x
// (tests/test_torch_tensor_core_plan.py), where the down FIR in 3xTF32 keeps
// within a quarter of it.
//
// The down FIR as an m16n8k8 product: row r of the warp's 16 x 16 output
// tile holds outputs s + 16 r + j, j < 16 (the last 8 beyond the 248 are
// dropped); A[r][kk] = E[s - 3 + 16 r + kk] (kk < 24) beside
// A[r][24 + kk] = O[s - 3 + 16 r + kk], K = 48; B_dn [48, 16] has
// B[kk][j] = de[kk - j - 1] and B[24 + kk][j] = do[kk - j]
// (ops/snake_cuda.py::fir_matrices). Of its 6 x 2 (k-step, n-tile) pairs
// 8 hold a tap; each is three mma (lo x hi, hi x lo, hi x hi), 24 a segment.
//
// Split once: each lane splits its 16 phases into TF32 hi and lo as it
// writes them to the warp's shared region (4 arrays: E hi, E lo, O hi, O
// lo), and the mma fragments are read ready. The arrays are stored
// permuted, index i at [i % 4][i / 4] with a row of 72 floats (= 8 mod
// 32), so a lane writes its two values of one residue as one 8-byte store
// and reads the 6 values of one fragment row as two 16-byte loads, all free
// of bank conflicts. The taps' split is made once on the host; a block
// keeps each lane's B fragments in shared memory (one 16-byte load a pair).
// A warp touches only its own region: __syncwarp, no block barrier past
// the start; three blocks an SM (at most 85 registers a thread).
//
// Staging: a warp walks segments g, g + stride, ... (stride = the grid's
// warps) and loads the next segment's run of x while it computes the current
// one; the load is 16 bytes at a time, element by element only where a run
// crosses a row edge or an unaligned address.
//
// Bound: HBM bytes, as the direct kernel (x read once, out written once);
// the 24 mma a 248-output segment are far below the tensor cores' rate.
// Measured on an H100 (PERF.md, tc_probe.py): 28.9 us a call at the long
// stages against the direct kernel's 19.2 (the previous tile-based form
// 48.6). The tensor-core down FIR costs about what the 12 FFMA an output
// it replaces did (the split, the shared round trip, the mma), and 78
// registers leave 3 blocks an SM where the direct kernel keeps 5; asking
// ptxas for 2 or 4, or launching more blocks, was slower.

#include <cstdint>

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

constexpr int kRow = 72;              // floats a permuted row: 68 read, = 8 mod 32
constexpr int kArr = 4 * kRow;        // one array of 256 phases (+ zero pad)
constexpr int kWarpSmem = 4 * kArr;   // E hi, E lo, O hi, O lo
constexpr int kDnElems = 48 * 16;     // B_dn
// (k-step, n-tile) pairs of B_dn that hold a tap: (0, 0), (1, 0), (1, 1),
// (2, 1) of E, then the same of O at k-steps 3-5
constexpr int kPairs = 8;
__device__ __forceinline__ constexpr int pair_ks(int p) {
  return 3 * (p >> 2) + (((p & 3) + 1) >> 1);
}
__device__ __forceinline__ constexpr int pair_nt(int p) { return (p & 3) >> 1; }

// warp segment g of the plan: its row's offset and channel, its first output
// s and the outputs [lo, hi) it writes (as snake_alias.cu computes them)
struct Segment {
  long long row_off;
  int c, s, lo, hi;
};

template <typename T>
__device__ __forceinline__ Segment segment(long long g, int channels, int len, int n_seg) {
  Segment sg;
  const long long row = g / n_seg;
  sg.c = (int)(row % channels);
  sg.row_off = row * len;
  sg.s = (int)(g - row * n_seg) * kSegLen - (int)(sg.row_off % kVec<T>);
  sg.lo = max(sg.s, 0);
  sg.hi = min(sg.s + kSegLen, len);
  return sg;
}

template <typename T>
__device__ __forceinline__ void store_pair_in(T* row, int q, int lo, int hi, float v0, float v1) {
  if (q >= lo && q + 1 < hi && aligned_pair(row + q)) {
    store_pair(row + q, v0, v1);
  } else {
    if (q >= lo && q < hi) store(row + q, v0);
    if (q + 1 >= lo && q + 1 < hi) store(row + q + 1, v1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
snake_alias_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                       const float* __restrict__ alpha, const float* __restrict__ beta,
                       const float* __restrict__ fir, const Taps taps, int channels, int len,
                       int n_seg, long long warps) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kLanes - 1), wid = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float* const region = reinterpret_cast<float*>(smem4) + wid * kWarpSmem;
  // the pad past 256 phases (read by row 15 for dropped outputs) stays 0
  for (int i = lane; i < 4 * 4 * (kRow - 64); i += kLanes) {
    const int arr = i / (4 * (kRow - 64)), rem = i % (4 * (kRow - 64));
    region[arr * kArr + (rem / (kRow - 64)) * kRow + 64 + rem % (kRow - 64)] = 0.0f;
  }

  // B_dn fragments of the 8 pairs from the host's split, per lane (hi of
  // b0, b1, then lo), in shared memory after the warps' regions
  float4* const bfrag = reinterpret_cast<float4*>(smem4) + kWarps * kWarpSmem / 4;
  {
    const int p = threadIdx.x / kLanes, at = (8 * pair_ks(p) + tig) * 16 + 8 * pair_nt(p) + gid;
    bfrag[threadIdx.x] = make_float4(fir[at], fir[at + 4 * 16], fir[kDnElems + at],
                                     fir[kDnElems + at + 4 * 16]);
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * kWarps;
  long long g = (long long)blockIdx.x * kWarps + wid;
  float own[kRun];  // this lane's run of x in segment g
  if (g < warps) {
    const Segment sg = segment<T>(g, channels, len, n_seg);
    load_run<false>(x + sg.row_off, sg.s + lane * kRun, len, own);
  }
  for (; g < warps; g += stride) {
    const Segment sg = segment<T>(g, channels, len, n_seg);
    const T* xr = x + sg.row_off;
    const int q0 = sg.s + lane * kRun;
    float xe[kRun + 6];  // x[q0 - 6 + i]
#pragma unroll
    for (int i = 0; i < kRun; ++i) xe[6 + i] = own[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float v = __shfl_up_sync(kFull, own[kRun - 6 + i], 1);
      if (lane == 0) v = x_at(xr, q0 - 6 + i, len);
      xe[i] = v;
    }
    // the next segment's run, in flight while this one computes
    if (g + stride < warps) {
      const Segment nx = segment<T>(g + stride, channels, len, n_seg);
      load_run<false>(x + nx.row_off, nx.s + lane * kRun, len, own);
    }
    if (sg.lo >= sg.hi) continue;  // a segment wholly before the row (uniform)

    const float a = expf(alpha[sg.c]);
    const float ib = 1.0f / (expf(beta[sg.c]) + 1e-9f);
    float ph_e[kRun + 6], ph_o[kRun + 5];  // E, O at q0 - 3 + j (j < kRun)
    snake_phases(taps, xe, q0 - 3, sg.s - 3, len, a, ib, ph_e, ph_o);

    // split once, write the lane's 8 + 8 phases: index 8 lane + j at
    // [j % 4][2 lane + j / 4], two values of one residue per 8-byte store
    __syncwarp();  // the previous segment's fragment loads are done
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float eh0, el0, eh1, el1, oh0, ol0, oh1, ol1;
      tf32_split(ph_e[r], eh0, el0);
      tf32_split(ph_e[r + 4], eh1, el1);
      tf32_split(ph_o[r], oh0, ol0);
      tf32_split(ph_o[r + 4], oh1, ol1);
      const int at = r * kRow + 2 * lane;
      *reinterpret_cast<float2*>(region + at) = make_float2(eh0, eh1);
      *reinterpret_cast<float2*>(region + kArr + at) = make_float2(el0, el1);
      *reinterpret_cast<float2*>(region + 2 * kArr + at) = make_float2(oh0, oh1);
      *reinterpret_cast<float2*>(region + 3 * kArr + at) = make_float2(ol0, ol1);
    }
    __syncwarp();

    // A fragments: row gid and gid + 8 of the tile, index 16 r + tig + 4 j
    // (j = 2 ks + h) at [tig][4 r + j]
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int phase = 0; phase < 2; ++phase) {  // E, then O
      float v[2][2][8];                        // [hi, lo][row gid, gid + 8][j]
#pragma unroll
      for (int part = 0; part < 2; ++part) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* p = region + (2 * phase + part) * kArr + tig * kRow + 4 * (gid + 8 * half);
          const float4 u0 = *reinterpret_cast<const float4*>(p);
          const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
          v[part][half][0] = u0.x, v[part][half][1] = u0.y;
          v[part][half][2] = u0.z, v[part][half][3] = u0.w;
          v[part][half][4] = u1.x, v[part][half][5] = u1.y;
          v[part][half][6] = u1.z, v[part][half][7] = u1.w;
        }
      }
#pragma unroll
      for (int p = 4 * phase; p < 4 * phase + 4; ++p) {
        const int ks = pair_ks(p) - 3 * phase;
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          uint32_t (&a)[4] = part ? a_lo : a_hi;
          a[0] = __float_as_uint(v[part][0][2 * ks]);
          a[1] = __float_as_uint(v[part][1][2 * ks]);
          a[2] = __float_as_uint(v[part][0][2 * ks + 1]);
          a[3] = __float_as_uint(v[part][1][2 * ks + 1]);
        }
        const float4 bv = bfrag[p * kLanes + lane];
        const uint32_t b_hi[2] = {__float_as_uint(bv.x), __float_as_uint(bv.y)};
        const uint32_t b_lo[2] = {__float_as_uint(bv.z), __float_as_uint(bv.w)};
        mma_3xtf32(acc[pair_nt(p)], a_hi, a_lo, b_hi, b_lo);
      }
    }

    // C fragments: outputs s + 16 r + 8 nt + 2 tig + {0, 1}, r = gid, gid + 8
    T* outr = out + sg.row_off;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 16 * (gid + 8 * half) + 8 * nt + 2 * tig;
        if (q < kSegLen) {
          store_pair_in(outr, sg.s + q, sg.lo, sg.hi, acc[nt][2 * half], acc[nt][2 * half + 1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); alpha, beta: device float32 [C]; fir: device float32
// [B_dn hi 48x16, B_dn lo], row-major, every value a TF32 number; taps: host
// float32[24] as ae, ao, de, do; n_seg segments of seg_len (248) outputs per
// row, as snake_alias_forward takes them (ops/snake_cuda.py::snake_plan);
// blocks: the grid (each warp walks its segments at a stride of the grid's
// warps). Launches on `stream` and returns cudaGetLastError().
int snake_alias_mma_forward(const void* x, void* out, const void* alpha, const void* beta,
                            const void* fir, const float* taps, int is_bf16, int batch,
                            int channels, int len, int n_seg, int seg_len, int blocks,
                            void* stream) {
  const int lead = is_bf16 ? kVec<__nv_bfloat16> - 1 : kVec<float> - 1;
  if (seg_len != kSegLen || n_seg < 1 || blocks < 1 ||
      (long long)n_seg * seg_len < (long long)len + lead) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps t = load_taps(taps);
  const long long warps = (long long)batch * channels * n_seg;
  const long long need = (warps + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(need < blocks ? need : blocks);
  const size_t smem = sizeof(float) * kWarps * kWarpSmem + sizeof(float4) * kPairs * kLanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const float* f = static_cast<const float*>(fir);
  if (is_bf16) {
    snake_alias_mma_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), a, b, f, t,
        channels, len, n_seg, warps);
  } else {
    snake_alias_mma_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a, b, f, t, channels, len,
        n_seg, warps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
