// Tensor-core form of the fused anti-aliased SnakeBeta for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisper_vits_svc_tpu/ops/pallas_snake.py::_kernel_nocopy_mxu (the
// `mxu=True` form of snake_alias_cm_pallas): the same function as
// snake_alias.cu, with the four 6-tap phase FIRs run as banded matrix
// products on the tensor cores. Snake, clamps and edges stay elementwise.
//
// The TPU's 136 x 256 and 272 x 128 matrices follow its 128 x 128 matrix
// unit. Here the products are `mma.sync.aligned.m16n8k8` on TF32 operands
// with f32 accumulation, and the windows fit that instruction:
//   up:   16 phase positions a window, 22 inputs, K = 24;
//         A[r][i] = x[P - 3 + i], B_up [24, 32]: columns 0..15 the even
//         phase (B[i][j] = ae[i - j]), 16..31 the odd (B[i][16 + j] =
//         ao[i - j - 1]);
//   down: 16 outputs a window, E and O windows side by side, K = 48;
//         A[r][i] = E[q - 2 + i], A[r][24 + i] = O[q - 3 + i],
//         B_dn [48, 16]: B[i][j] = de[i - j], B[24 + i][j] = do[i - j].
// Of the 12 + 12 (k-step, n-tile) pairs of B_up and B_dn only 8 + 8 hold a
// tap; the others are skipped. The 16 rows of one mma are 16 consecutive
// 64-sample segments of the block's 1024-sample tile, each staged with its
// own halo at a row stride of 100 floats, so that the 32 lanes of a fragment
// load fall on 32 different shared-memory banks (4 * row + k).
//
// Accuracy is f32 (the TPU runs these products at Precision.HIGHEST). The
// tensor cores take TF32 (10 mantissa bits), so each operand is split into a
// TF32 head and a TF32 remainder and three products are summed (lo x hi,
// hi x lo, hi x hi); lo x lo, about 2^-22 of the product, is dropped. The
// taps' split is made once on the host (ops/snake_cuda.py::fir_matrices);
// the data's is made as fragments are loaded. One plain TF32 product would
// err by about 1e-3 relative.
//
// Bound: HBM bytes, as the direct kernel (x read once, out written once);
// the 216 mma a tile are far below the tensor cores' rate.

#include <cstdint>

#include "snake_alias.cuh"

namespace {

using namespace snake_alias;

constexpr int kTile = 1024;           // outputs a block
constexpr int kRows = 16;             // rows of one mma: segments of the tile
constexpr int kSeg = 64;              // outputs per row
constexpr int kRowX = 88;             // staged x per row: positions seg - 11 .. seg + 76
constexpr int kStride = 100;          // row stride in shared memory, = 4 mod 32
constexpr int kUpWindows = 5;         // 80 phase positions per row: seg - 8 .. seg + 71
constexpr int kUpElems = 24 * 32;     // B_up
constexpr int kDnElems = 48 * 16;     // B_dn

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

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A x B in three TF32 products, A split here, B split by the host. p
// points at A[row gid][k tig] of the 16 x 8 step in shared memory.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const float* p,
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  const float av[4] = {p[0], p[8 * kStride], p[4], p[8 * kStride + 4]};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32(av[i]);
    lo[i] = tf32(av[i] - __uint_as_float(hi[i]));
  }
  mma_tf32(c, lo, b_hi);
  mma_tf32(c, hi, b_lo);
  mma_tf32(c, hi, b_hi);
}

// fragment of B [K, n_cols] (hi at b, lo at b + elems) for k-step ks, n-tile nt
__device__ __forceinline__ void load_b(const float* __restrict__ b, int elems, int n_cols,
                                       int ks, int nt, int gid, int tig, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const int at = (8 * ks + tig) * n_cols + 8 * nt + gid;
  hi[0] = __float_as_uint(b[at]);
  hi[1] = __float_as_uint(b[at + 4 * n_cols]);
  lo[0] = __float_as_uint(b[elems + at]);
  lo[1] = __float_as_uint(b[elems + at + 4 * n_cols]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_alias_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                       const float* __restrict__ alpha, const float* __restrict__ beta,
                       const float* __restrict__ fir, const Taps taps, int channels, int len) {
  __shared__ float xs[kRows * kStride];
  __shared__ float ph_e[kRows * kStride];
  __shared__ float ph_o[kRows * kStride];
  __shared__ float edge[2];

  const int c = blockIdx.y;
  const long long row_off = ((long long)blockIdx.z * channels + c) * len;
  const T* xr = x + row_off;
  T* outr = out + row_off;
  const int t0 = blockIdx.x * kTile;
  const float a = expf(alpha[c]);
  const float ib = 1.0f / (expf(beta[c]) + 1e-9f);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // this warp's B fragments. Up: n-tile nt_u (0, 1 even phase; 2, 3 odd) of
  // windows wid / 4, + 2, ...; its taps lie in k-steps ks_u and ks_u + 1.
  const int nt_u = wid & 3, ks_u = nt_u & 1;
  uint32_t bu_hi[2][2], bu_lo[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    load_b(fir, kUpElems, 32, ks_u + s, nt_u, gid, tig, bu_hi[s], bu_lo[s]);
  }
  // Down: window v, n-tile nt_d; taps in k-steps nt_d, nt_d + 1 (E) and
  // nt_d + 3, nt_d + 4 (O).
  const int v = wid >> 1, nt_d = wid & 1;
  uint32_t bd_hi[4][2], bd_lo[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    load_b(fir + 2 * kUpElems, kDnElems, 16, nt_d + s + (s >> 1), nt_d, gid, tig, bd_hi[s],
           bd_lo[s]);
  }

  // xs[r][i] = x[t0 + 64 r - 11 + i], edge-replicated by the clamped index
  for (int idx = threadIdx.x; idx < kRows * kRowX; idx += kThreads) {
    const int r = idx / kRowX, i = idx - r * kRowX;
    xs[r * kStride + i] = x_at(xr, t0 + kSeg * r - 11 + i, len);
  }
  if (threadIdx.x == 0 && t0 - 8 < 0) {
    edge[0] = head_clamp(xr, len, a, ib, taps);
  }
  if (threadIdx.x == 32 && t0 + kTile + 7 > len - 1) {
    edge[1] = tail_clamp(xr, len, a, ib, taps);
  }
  __syncthreads();

  // up: phases at l = 16 w + j of row r, position t0 + 64 r - 8 + l;
  // A[r][i] = xs[r][16 w + i] (se[l] reads xs[l + m], so[l] reads xs[l + 1 + m])
  float* ph = (nt_u >> 1) ? ph_o : ph_e;
  for (int w = wid >> 2; w < kUpWindows; w += 2) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mma_3xtf32(acc, xs + gid * kStride + 16 * w + 8 * (ks_u + s) + tig, bu_hi[s], bu_lo[s]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gid + 8 * (i >> 1);
      const int l = 16 * w + 8 * (nt_u & 1) + 2 * tig + (i & 1);
      const int p = t0 + kSeg * r - 8 + l;
      ph[r * kStride + l] = p < 0 ? edge[0] : (p > len - 1 ? edge[1] : snake(acc[i], a, ib));
    }
  }
  __syncthreads();

  // down: outputs q = 64 r + 16 v + j; E[q - 2 + i] is ph_e[r][16 v + 6 + i],
  // O[q - 3 + i] is ph_o[r][16 v + 5 + i]
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* p = s < 2 ? ph_e + 16 * v + 6 + 8 * (nt_d + s)
                           : ph_o + 16 * v + 5 + 8 * (nt_d + s - 2);
    mma_3xtf32(acc, p + gid * kStride + tig, bd_hi[s], bd_lo[s]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = t0 + kSeg * (gid + 8 * (i >> 1)) + 16 * v + 8 * nt_d + 2 * tig + (i & 1);
    if (q < len) store(outr + q, acc[i]);
  }
}

}  // namespace

extern "C" {

// x, out: device [B, C, T] contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); alpha, beta: device float32 [C]; fir: device float32
// [B_up hi 24x32, B_up lo, B_dn hi 48x16, B_dn lo], row-major, every value a
// TF32 number; taps: host float32[24] as ae, ao, de, do (the clamp values).
// Launches on `stream` and returns cudaGetLastError().
int snake_alias_mma_forward(const void* x, void* out, const void* alpha, const void* beta,
                            const void* fir, const float* taps, int is_bf16, int batch,
                            int channels, int len, void* stream) {
  const Taps t = load_taps(taps);
  const dim3 grid((len + kTile - 1) / kTile, channels, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const float* f = static_cast<const float*>(fir);
  if (is_bf16) {
    snake_alias_mma_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), a, b, f, t,
        channels, len);
  } else {
    snake_alias_mma_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a, b, f, t, channels, len);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* snake_alias_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
