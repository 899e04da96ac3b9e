// One layer of CREPE's convolution stack as one launch, for Hopper (sm_90a):
// a float32 conv1d as an implicit GEMM on the CUDA cores, then bias, ReLU,
// the folded BatchNorm affine and the max-pool by 2.
//
// Replaces no Pallas kernel: the JAX package leaves CREPE's convolutions to
// XLA (whisper_vits_svc_tpu/models/crepe.py), and the port ran them through
// cuDNN (F.conv1d), whose float32 choice at these shapes is its legacy
// implicit_convolve_sgemm. For rows n, output channels co and positions t:
//   y[n, co, t] = sum over (ci, k) of w[co, ci, k] * x[n, ci, t*stride + k - pad]
//   z = relu(y + b[co]) * scale[co] + shift[co]     (a multiply, then an add)
//   out[n, co, t/2] = max(z[.., 2m], z[.., 2m + 1])  (NaN wins, as max_pool1d)
// Positions outside the input read 0 (the zero padding is never made).
//
// Bound: float32 FMAs. CREPE "full" is 2.82 GFLOP a frame, 76% of it in the
// second layer (1024 channels in, 128 out, 64 taps over 128 positions:
// M = N = 128, K = 65,536 a row), so a layer reads its operands from L2 and
// shared memory far faster than the card's 67 TFLOP/s consume them; the
// bytes (weights once, activations in and out) are 1-3% of that time.
// No TF32: the configuration is float32.
//
// Design. A block computes a tile of BM output channels x 128 positions,
// a thread 8 channels (ty + BM/8 i) x 8 consecutive positions in registers.
// The K walk goes channel by channel, 64 taps a stage; each stage's weights
// (BM x 64, rows padded to 68 floats so that a warp's two rows fall in
// other banks) and its input window, loaded once per channel and row
// segment ([segment + 63] values), are copied into shared memory with
// cp.async, double-buffered. The im2col operand is read from the window by
// offset: a thread's 8 positions at tap k are window[t0 + k .. t0 + k + 7],
// so eight taps need 8 new values (two 16-byte loads) and the rest shift
// through registers; the weights come as float4s of 4 taps. Eight taps are
// 512 FMAs a thread for 18 shared-memory loads. Rows with fewer than 128
// positions (later layers: 64 .. 8) share a tile, a window segment each. A
// strided layer (the first: one channel, 512 taps, stride 4) is walked as 4
// phase channels of 128 taps (tap 4q + r reads x[4 (t + q) + r - pad]), so
// every layer is stride 1 inside the kernel. Split-K: where the tiles fill
// fewer than the card's block slots (64 rows at 128 positions are 64 tiles
// of the second layer), the channels are cut into `splits` ranges; each
// block writes its partial tile to a workspace, takes an integer ticket of
// its tile, and the block that takes the last one sums the slots in slot
// order (its own from registers) and runs the epilogue, then sets the
// ticket back to 0. No float atomics: a call is bitwise repeatable. The
// wrapper (ops/crepe_conv_cuda.py::plan) chooses BM from the output
// channels and the splits from the tiles and the card's slots.

#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;      // positions a tile
constexpr int kBK = 64;       // taps a stage
constexpr int kAStride = 68;  // a weight row in shared memory (floats)
constexpr int kMaxRows = kBN / 8;  // row segments a tile, at 8 positions a row

struct Args {
  const float* x;
  long long sx_n, sx_c;  // x's row and channel strides (elements)
  int len_in, xstride, cphase, pad;  // x index = u * xstride + c * cphase - pad
  const float* w;
  long long sw_co, sw_c, sw_k;  // weight strides of the K walk's (co, c, tap)
  const float* bias;
  const float* scale;
  const float* shift;
  float* out;  // [n, co, t / 2] contiguous
  int n, co, t, k;  // rows, out channels, positions before the pool, the K walk's taps
  int seg, rows_per_tile, segs_per_row, pos_tiles, co_tiles, splits, iters;
  float4* ws;  // splits > 1: [tiles * splits][BM * 128 / 4]
  int* tickets;  // splits > 1: [tiles], all 0
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// max_pool1d's rule: the later value wins when larger or NaN
__device__ __forceinline__ float pool2(float a, float b) { return (b > a || b != b) ? b : a; }

template <int BM>
__host__ __device__ constexpr int stage_floats(int window) {
  return BM * kAStride + window;
}

// One stage: the weights of channel c, taps kc0 .. kc0 + 63, and the
// input windows of the tile's row segments.
template <int BM, bool kVecW>
__device__ __forceinline__ void load_stage(const Args& a, float* as, float* bs, int it,
                                           int co0, int pos_tile, int tid) {
  constexpr int kThreads = 2 * BM;
  const int chunks = a.k / kBK;
  const int c = it / chunks;
  const int kc0 = (it - c * chunks) * kBK;
  for (int e = tid; e < BM * (kBK / 4); e += kThreads) {
    const int row = e >> 4;
    const int q = (e & 15) * 4;
    const int co = co0 + row;
    const bool valid = co < a.co;
    const float* src = a.w + (valid ? co * a.sw_co + c * a.sw_c : 0);
    float* dst = as + row * kAStride + q;
    if (kVecW) {
      cp_async16(dst, valid ? src + kc0 + q : a.w, valid);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cp_async4(dst + r, valid ? src + (kc0 + q + r) * a.sw_k : a.w, valid);
    }
  }
  const int wlen = a.seg + kBK;
  const int total = a.rows_per_tile * wlen;
  for (int e = tid; e < total; e += kThreads) {
    const int r = e / wlen;
    const int p = e - r * wlen;
    const int g = pos_tile * a.rows_per_tile + r;  // the row segment
    const int row = g / a.segs_per_row;
    const int u = (g - row * a.segs_per_row) * a.seg + kc0 + p;
    const int idx = u * a.xstride + c * a.cphase - a.pad;
    const bool valid = row < a.n && p < a.seg + kBK - 1 && idx >= 0 && idx < a.len_in;
    cp_async4(bs + e, valid ? a.x + row * a.sx_n + c * a.sx_c + idx : a.x, valid);
  }
}

// No minimum of resident blocks in the launch bounds: held to 128
// registers a thread, ptxas spilled ~700 B a thread; left free it takes
// 122-124 and spills nothing, so two blocks of 256 threads still share an
// SM (the wrapper asks the card how many fit).
template <int BM, bool kVecW>
__global__ void __launch_bounds__(2 * BM)
crepe_conv_kernel(Args a) {
  constexpr int kThreads = 2 * BM;
  constexpr int kRowStep = BM / 8;  // a thread's channels are ty + kRowStep * i
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int split = blockIdx.x % a.splits;
  const int tile = blockIdx.x / a.splits;
  const int co_tile = tile % a.co_tiles;
  const int pos_tile = tile / a.co_tiles;
  const int co0 = co_tile * BM;
  const int wlen = a.seg + kBK;
  const int stage = stage_floats<BM>(a.rows_per_tile * wlen);
  const int it0 = static_cast<int>(static_cast<long long>(split) * a.iters / a.splits);
  const int it1 = static_cast<int>(static_cast<long long>(split + 1) * a.iters / a.splits);

  // this thread's 8 positions: row segment r_thr, from t_loc
  const int p0 = tx * 8;
  const int r_thr = p0 / a.seg;
  const int t_loc = p0 - r_thr * a.seg;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_stage<BM, kVecW>(a, smem, smem + BM * kAStride, it0, co0, pos_tile, tid);
  cp_async_commit();
  int buf = 0;
  for (int it = it0; it < it1; ++it) {
    if (it + 1 < it1) {
      float* next = smem + (buf ^ 1) * stage;
      load_stage<BM, kVecW>(a, next, next + BM * kAStride, it + 1, co0, pos_tile, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = smem + buf * stage + ty * kAStride;
    const float* bs = smem + buf * stage + BM * kAStride + r_thr * wlen + t_loc;
    float win[16];
    {
      const float4 w0 = *reinterpret_cast<const float4*>(bs);
      const float4 w1 = *reinterpret_cast<const float4*>(bs + 4);
      win[0] = w0.x; win[1] = w0.y; win[2] = w0.z; win[3] = w0.w;
      win[4] = w1.x; win[5] = w1.y; win[6] = w1.z; win[7] = w1.w;
    }
#pragma unroll 1
    for (int kc = 0; kc < kBK; kc += 8) {
      {
        const float4 w0 = *reinterpret_cast<const float4*>(bs + kc + 8);
        const float4 w1 = *reinterpret_cast<const float4*>(bs + kc + 12);
        win[8] = w0.x; win[9] = w0.y; win[10] = w0.z; win[11] = w0.w;
        win[12] = w1.x; win[13] = w1.y; win[14] = w1.z; win[15] = w1.w;
      }
      // four taps of four channels at a time: a float4 of taps a channel
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          float4 av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] = *reinterpret_cast<const float4*>(as + (h + i) * kRowStep * kAStride + kc +
                                                     4 * g);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float wv = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[h + i][j] = fmaf(wv, win[4 * g + kk + j], acc[h + i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) win[j] = win[8 + j];
    }
    __syncthreads();
    buf ^= 1;
  }

  if (a.splits > 1) {
    // this block's partial tile into its slot; the tile's last block sums
    // the slots in slot order
    float4* slots = a.ws + static_cast<long long>(tile) * a.splits * (BM * kBN / 4);
    float4* mine = slots + static_cast<long long>(split) * (BM * kBN / 4);
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const int i = v >> 1, j = (v & 1) * 4;
      mine[v * kThreads + tid] = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(a.tickets + tile, 1) == a.splits - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const int i = v >> 1, j = (v & 1) * 4;
      const float4 own = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      float4 sum = split == 0 ? own : __ldcg(slots + v * kThreads + tid);
      for (int s = 1; s < a.splits; ++s)
        sum = add4(sum, s == split ? own : __ldcg(slots + static_cast<long long>(s) * (BM * kBN / 4)
                                                    + v * kThreads + tid));
      acc[i][j] = sum.x;
      acc[i][j + 1] = sum.y;
      acc[i][j + 2] = sum.z;
      acc[i][j + 3] = sum.w;
    }
    if (tid == 0) a.tickets[tile] = 0;
  }

  // epilogue: bias, ReLU, affine, the pool by 2; 4 pooled outputs a channel
  const int g = pos_tile * a.rows_per_tile + r_thr;
  const int row = g / a.segs_per_row;
  if (row >= a.n) return;
  const int t = (g - row * a.segs_per_row) * a.seg + t_loc;
  const int half = a.t / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + ty + kRowStep * i;
    if (co >= a.co) continue;
    const float b = a.bias[co], sc = a.scale[co], sh = a.shift[co];
    float z[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = acc[i][j] + b;
      y = y < 0.0f ? 0.0f : y;  // NaN stays NaN, as relu
      z[j] = __fadd_rn(__fmul_rn(y, sc), sh);
    }
    float4 o = make_float4(pool2(z[0], z[1]), pool2(z[2], z[3]), pool2(z[4], z[5]),
                           pool2(z[6], z[7]));
    *reinterpret_cast<float4*>(a.out + (static_cast<long long>(row) * a.co + co) * half + t / 2) = o;
  }
}

template <int BM>
int max_smem_bytes() {
  return 2 * stage_floats<BM>(kMaxRows * (8 + kBK)) * static_cast<int>(sizeof(float));
}

constexpr int kMaxDevices = 64;

template <int BM, bool kVecW>
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(crepe_conv_kernel<BM, kVecW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes<BM>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int BM, bool kVecW>
int launch(const Args& a, cudaStream_t stream) {
  const cudaError_t err = configure<BM, kVecW>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int window = a.rows_per_tile * (a.seg + kBK);
  const int smem = 2 * stage_floats<BM>(window) * static_cast<int>(sizeof(float));
  const unsigned blocks = static_cast<unsigned>(a.pos_tiles) * a.co_tiles * a.splits;
  crepe_conv_kernel<BM, kVecW><<<blocks, 2 * BM, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int blocks_per_sm(int* blocks) {
  cudaError_t err = configure<BM, true>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, crepe_conv_kernel<BM, true>, 2 * BM,
                                                        max_smem_bytes<BM>());
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// x: device float32, element (row, c, i) at x + row * sx_n + c * sx_c + i,
// i in [0, len_in); the K walk's channel c and tap q read x index
// u * xstride + c * cphase - pad with u = t + q (0 outside the input).
// w: device float32, (co, c, q) at w + co * sw_co + c * sw_c + q * sw_k.
// bias, scale, shift: device float32 [co]; out: device float32 [n, co, t / 2]
// contiguous. t: positions before the pool, a multiple of 8, dividing 128
// or a multiple of it; k: the walk's taps, a multiple of 64; bm: 32, 64 or
// 128; splits in [1, ci * k / 64]; with splits > 1, ws: device float32
// [tiles * splits * bm * 128] and tickets: device int32 [tiles], all 0 (the
// kernel leaves them 0). One launch on `stream`; returns cudaGetLastError()
// or cudaErrorInvalidValue for arguments outside these rules.
int crepe_conv_forward(const void* x, long long sx_n, long long sx_c, int len_in, int xstride,
                       int cphase, int pad, const void* w, long long sw_co, long long sw_c,
                       long long sw_k, const void* bias, const void* scale, const void* shift,
                       void* out, int n, int co, int t, int ci, int k, int bm, int splits,
                       void* ws, void* tickets, void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.sx_n = sx_n;
  a.sx_c = sx_c;
  a.len_in = len_in;
  a.xstride = xstride;
  a.cphase = cphase;
  a.pad = pad;
  a.w = static_cast<const float*>(w);
  a.sw_co = sw_co;
  a.sw_c = sw_c;
  a.sw_k = sw_k;
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.co = co;
  a.t = t;
  a.k = k;
  const bool shape_ok = n >= 1 && co >= 1 && ci >= 1 && len_in >= 1 && xstride >= 1 &&
                        t >= 8 && t % 8 == 0 && (t <= kBN ? kBN % t == 0 : t % kBN == 0) &&
                        k >= kBK && k % kBK == 0 && (bm == 32 || bm == 64 || bm == 128);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  a.seg = t < kBN ? t : kBN;
  a.rows_per_tile = kBN / a.seg;
  a.segs_per_row = t / a.seg;
  const long long pos_tiles =
      ((long long)n * a.segs_per_row + a.rows_per_tile - 1) / a.rows_per_tile;
  a.pos_tiles = static_cast<int>(pos_tiles);
  a.co_tiles = (co + bm - 1) / bm;
  a.iters = static_cast<int>((long long)ci * (k / kBK));
  a.splits = splits;
  a.ws = static_cast<float4*>(ws);
  a.tickets = static_cast<int*>(tickets);
  if (splits < 1 || splits > a.iters || (splits > 1 && (ws == nullptr || tickets == nullptr)) ||
      pos_tiles * a.co_tiles * splits >= (1LL << 31) ||
      (long long)ci * k >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // the weights as 16-byte copies where the taps are contiguous and aligned
  const bool vec = sw_k == 1 && sw_co % 4 == 0 && sw_c % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 32: return vec ? launch<32, true>(a, s) : launch<32, false>(a, s);
    case 64: return vec ? launch<64, true>(a, s) : launch<64, false>(a, s);
    default: return vec ? launch<128, true>(a, s) : launch<128, false>(a, s);
  }
}

// The kernel's resident blocks an SM at its largest shared memory, for a
// tile of bm channels (32, 64 or 128), into *blocks.
int crepe_conv_blocks_per_sm(int bm, int* blocks) {
  switch (bm) {
    case 32: return blocks_per_sm<32>(blocks);
    case 64: return blocks_per_sm<64>(blocks);
    case 128: return blocks_per_sm<128>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* crepe_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
