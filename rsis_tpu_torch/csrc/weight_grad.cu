// Weight gradient of the ConvLSTM gate convolution for Hopper (sm_90a).
//
// Replaces: rsis_tpu/ops/pallas_decode_vjp.py::weight_grad_rowmajor
// (kernel body _dwt_kernel). Computes
//   dwt[n, k] = sum over pixels (b, y, x) of dg[b, y, n, x] * tap_k(b, y, x)
// for the packed (4C, 9(Cx+C)) layout of pack_cell_weights, where column
// k = (tap, channel) reads x_pad[b, y + dy, ch, x + dx] for the Cx x
// channels (the ring read as given) and h_prev[b, y + dy - 1, ch - Cx,
// x + dx - 1] for the C h channels (zero outside the image). The sum is
// taken in fp32 and cast once to dg's dtype.
//
// What bounds it on the card: a GEMM with M = 4C, N = 9(Cx+C) and the
// contraction over K = B * H * W pixels (up to 1M at the finest cell):
// 2 * M * N * K operations (about 14.5 GFLOP per cell at B = 32, 256x512)
// against dg, h_prev and x_pad read once; on the tensor cores the bytes
// bound it at every cell but the coarsest.
//
// Design. The TPU kernel carried one (4C, K) accumulator over its
// sequential grid; here blocks run in parallel and in no order, so the
// pixels are cut into chunks and a reduction follows in a fixed order:
//   pass 1: block (m-block, channel block, chunk) sums its chunk into an
//           fp32 partial tile ws[chunk][4C][9(Cx+C)] (every entry of the
//           tile written by exactly one thread);
//   pass 2: dwt[n, k] = sum over chunks in order, cast to dg's dtype.
// No atomics: the result is the same on every run.
// bf16 with C and Cx multiples of 8 runs mma.sync m16n8k16 with the
// pixels as the contraction: a block stages R rows of a tile of columns,
// the dg rows of its 32 gate channels [m][pixel] and the halo of its 32
// input channels [row][col][channel]; a warp owns 16 gate rows and one
// block of 8 channels for all 9 taps, A (dg) by ldmatrix and B (the
// shifted halo) by ldmatrix.trans, so the im2col taps never exist.
// Everything else runs an fp32 FMA loop over 16 x 16 output tiles.

#include <stdint.h>

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::kThreads;
using rsis::to_f;

constexpr int kMBlk = 32;    // gate rows per block (2 warps of 16)
constexpr int kCBlk = 32;    // input channels per block (4 warps of 8)
constexpr int kHStride = 40;  // halo channel stride: 40 / 8 = 5 is odd
constexpr int kRows = 4;      // output rows staged together
constexpr int kMaxTw = 128;   // columns staged together

__host__ __device__ inline int dg_stride(int tw) { return tw + 8; }

// Packed column of channel ch (of Cx + C) at tap t.
__device__ __forceinline__ int packed_col(int tap, int ch, int C, int Cx) {
  return ch < Cx ? tap * Cx + ch : 9 * Cx + tap * C + (ch - Cx);
}

struct Units {
  int n_row_groups, n_xt, tw;
  __host__ __device__ int count(int B) const {
    return B * n_row_groups * n_xt;
  }
};

__global__ void __launch_bounds__(kThreads)
dwt_mma_kernel(const __nv_bfloat16* __restrict__ h_prev,
               const __nv_bfloat16* __restrict__ x_pad,
               const __nv_bfloat16* __restrict__ dg, float* __restrict__ ws,
               int B, int H, int W, int C, int Cx, Units units, int n_mblk,
               int n_cblk, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tw = units.tw;
  const int twp = tw + 2;
  const int dstr = dg_stride(tw);
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dgs = halo + (size_t)(kRows + 2) * twp * kHStride;

  const int cn = Cx + C;
  const int M = 4 * C;
  const int mblk = blockIdx.x % n_mblk;
  const int cblk = (blockIdx.x / n_mblk) % n_cblk;
  const int chunk = blockIdx.x / (n_mblk * n_cblk);
  const int m0 = mblk * kMBlk;
  const int c0 = cblk * kCBlk;
  const int n_units = units.count(B);
  const int u_begin = (int)((long long)n_units * chunk / n_chunks);
  const int u_end = (int)((long long)n_units * (chunk + 1) / n_chunks);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wmi = warp % 2;      // 16-row half of the gate rows
  const int wci = warp / 2;      // 8-channel block of the channels
  const bool active = m0 + 16 * wmi < M && c0 + 8 * wci < cn;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

  // ldmatrix rows: A matrix (lane >> 3) = (gate half, pixel half), B
  // matrix (lane >> 3) & 1 = pixel half
  const int a_m = 16 * wmi + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_p = (lane >> 4) * 8;
  const int b_p = (lane & 7) + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  for (int u = u_begin; u < u_end; ++u) {
    const int xt = u % units.n_xt;
    const int y0 = (u / units.n_xt) % units.n_row_groups * kRows;
    const int b = u / (units.n_xt * units.n_row_groups);
    const int x0 = xt * tw;
    __syncthreads();  // the previous unit's fragments are read
    // halo: rows y0 - 1 .. y0 + kRows of channels c0 .. c0 + 31
    for (int i = threadIdx.x; i < (kRows + 2) * kCBlk * twp;
         i += blockDim.x) {
      const int col = i % twp;
      const int cc = (i / twp) % kCBlk;
      const int dy = i / (twp * kCBlk);
      const int ch = c0 + cc;
      __nv_bfloat16 v = zero;
      if (ch < Cx) {
        const int px = x0 + col;
        if (px < W + 2 && y0 + dy < H + 2)
          v = x_pad[((size_t)(b * (H + 2) + y0 + dy) * Cx + ch) * (W + 2) +
                    px];
      } else if (ch < cn) {
        const int iy = y0 + dy - 1;
        const int ix = x0 + col - 1;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v = h_prev[((size_t)(b * H + iy) * C + (ch - Cx)) * W + ix];
      }
      halo[(dy * twp + col) * kHStride + cc] = v;
    }
    // dg rows y0 .. y0 + kRows - 1 of gate rows m0 .. m0 + 31; pixels past
    // the image are zero, so they add nothing
    for (int i = threadIdx.x; i < kRows * kMBlk * tw; i += blockDim.x) {
      const int px = i % tw;
      const int m = (i / tw) % kMBlk;
      const int rr = i / (tw * kMBlk);
      __nv_bfloat16 v = zero;
      if (y0 + rr < H && x0 + px < W && m0 + m < M)
        v = dg[((size_t)(b * H + y0 + rr) * M + m0 + m) * W + x0 + px];
      dgs[(rr * kMBlk + m) * dstr + px] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int rr = 0; rr < kRows; ++rr) {
      for (int p0 = 0; p0 < tw; p0 += 16) {
        unsigned a[4];
        rsis::ldmatrix_x4(a, dgs + (size_t)(rr * kMBlk + a_m) * dstr + p0 +
                                 a_p);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          unsigned bb[2];
          rsis::ldmatrix_x2_trans(
              bb, halo + (size_t)((rr + t / 3) * twp + p0 + b_p + t % 3) *
                             kHStride +
                      8 * wci);
          rsis::mma_bf16(acc[t], a, bb[0], bb[1]);
        }
      }
    }
  }
  if (!active) return;
  // D fragment: rows lane / 4 (+ 8), columns 2 * (lane % 4) (+ 1)
  const int K = 9 * cn;
  float* out = ws + (size_t)chunk * M * K;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 16 * wmi + (lane >> 2) + (e >> 1) * 8;
      const int ch = c0 + 8 * wci + 2 * (lane & 3) + (e & 1);
      if (m < M && ch < cn)
        out[(size_t)m * K + packed_col(t, ch, C, Cx)] = acc[t][e];
    }
}

// fp32 FMA: block = a 16 x 16 tile of (gate row, packed column) and one
// chunk of pixels, 64 pixels staged at a time; thread (ty, tx) owns one
// entry.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwt_fma_kernel(const T* __restrict__ h_prev, const T* __restrict__ x_pad,
               const T* __restrict__ dg, float* __restrict__ ws, int B,
               int H, int W, int C, int Cx, int n_mt, int n_kt,
               int n_chunks) {
  __shared__ float dgs[16][65];
  __shared__ float taps[64][17];
  const int cn = Cx + C;
  const int M = 4 * C;
  const int K = 9 * cn;
  const int mt = blockIdx.x % n_mt;
  const int kt = (blockIdx.x / n_mt) % n_kt;
  const int chunk = blockIdx.x / (n_mt * n_kt);
  const long long P = (long long)B * H * W;
  const long long p_begin = P * chunk / n_chunks;
  const long long p_end = P * (chunk + 1) / n_chunks;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc = 0.0f;
  for (long long pb = p_begin; pb < p_end; pb += 64) {
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * 64; i += blockDim.x) {
      const int p = i % 64;
      const int r = i / 64;
      const long long pix = pb + p;
      const int m = mt * 16 + r;
      float dv = 0.0f;
      float tv = 0.0f;
      const int k = kt * 16 + r;
      if (pix < p_end) {
        const int x = (int)(pix % W);
        const int y = (int)((pix / W) % H);
        const int b = (int)(pix / ((long long)W * H));
        if (m < M) dv = to_f(dg[((size_t)(b * H + y) * M + m) * W + x]);
        if (k < K) {
          int tap, ch;
          if (k < 9 * Cx) {
            tap = k / Cx;
            ch = k % Cx;
            tv = to_f(x_pad[((size_t)(b * (H + 2) + y + tap / 3) * Cx + ch) *
                                (W + 2) +
                            x + tap % 3]);
          } else {
            tap = (k - 9 * Cx) / C;
            ch = (k - 9 * Cx) % C;
            const int iy = y + tap / 3 - 1;
            const int ix = x + tap % 3 - 1;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W)
              tv = to_f(h_prev[((size_t)(b * H + iy) * C + ch) * W + ix]);
          }
        }
      }
      dgs[r][p] = dv;
      taps[p][r] = tv;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < 64; ++p) acc = fmaf(dgs[ty][p], taps[p][tx], acc);
  }
  const int m = mt * 16 + ty;
  const int k = kt * 16 + tx;
  if (m < M && k < K) ws[((size_t)chunk * M + m) * K + k] = acc;
}

template <typename T>
__global__ void reduce_kernel(const float* __restrict__ ws,
                              T* __restrict__ out, int n_chunks,
                              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += ws[(size_t)c * n + i];
  out[i] = from_f<T>(s);
}

bool use_mma(int C, int Cx, int dtype) {
  return dtype == 1 && C % 8 == 0 && Cx % 8 == 0;
}

Units mma_units(int H, int W) {
  Units u;
  u.tw = ((W + 15) / 16) * 16;
  if (u.tw > kMaxTw) u.tw = kMaxTw;
  u.n_xt = (W + u.tw - 1) / u.tw;
  u.n_row_groups = (H + kRows - 1) / kRows;
  return u;
}

// Blocks of one chunk, and the number of chunks: enough blocks for two
// per SM (132 SMs), no more chunks than units of work.
void plan(int B, int H, int W, int C, int Cx, int dtype, int* per_chunk,
          int* n_chunks) {
  long long units;
  if (use_mma(C, Cx, dtype)) {
    *per_chunk = ((4 * C + kMBlk - 1) / kMBlk) * ((Cx + C + kCBlk - 1) / kCBlk);
    units = mma_units(H, W).count(B);
  } else {
    *per_chunk = ((4 * C + 15) / 16) * ((9 * (Cx + C) + 15) / 16);
    units = ((long long)B * H * W + 255) / 256;
  }
  long long chunks = (264 + *per_chunk - 1) / *per_chunk;
  if (chunks > units) chunks = units;
  if (chunks < 1) chunks = 1;
  *n_chunks = (int)chunks;
}

}  // namespace

// Floats of fp32 workspace that rsis_weight_grad needs for these shapes.
extern "C" long long rsis_weight_grad_workspace(int B, int H, int W, int C,
                                                int Cx, int dtype) {
  int per_chunk, n_chunks;
  plan(B, H, W, C, Cx, dtype, &per_chunk, &n_chunks);
  return (long long)n_chunks * 4 * C * 9 * (Cx + C);
}

// h_prev (B, H, C, W), x_pad (B, H+2, Cx, W+2) or null when Cx == 0,
// dg (B, H, 4C, W) -> dwt (4C, 9(Cx+C)) in dg's dtype; ws holds
// ws_floats floats (rsis_weight_grad_workspace). dtype: 0 = float32,
// 1 = bfloat16. Returns the first failing launch's cudaError_t, 0 on
// success.
extern "C" int rsis_weight_grad(const void* h_prev, const void* x_pad,
                                const void* dg, void* ws, long long ws_floats,
                                void* dwt, int B, int H, int W, int C, int Cx,
                                int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cx < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (ws_floats < rsis_weight_grad_workspace(B, H, W, C, Cx, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per_chunk, n_chunks;
  plan(B, H, W, C, Cx, dtype, &per_chunk, &n_chunks);
  const long long blocks = (long long)per_chunk * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  if (use_mma(C, Cx, dtype)) {
    const Units u = mma_units(H, W);
    const size_t smem =
        ((size_t)(kRows + 2) * (u.tw + 2) * kHStride +
         (size_t)kRows * kMBlk * dg_stride(u.tw)) *
        sizeof(__nv_bfloat16);
    cudaError_t err = cudaFuncSetAttribute(
        dwt_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    using bf = __nv_bfloat16;
    dwt_mma_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const bf*>(h_prev), static_cast<const bf*>(x_pad),
        static_cast<const bf*>(dg), w, B, H, W, C, Cx, u,
        (4 * C + kMBlk - 1) / kMBlk, (Cx + C + kCBlk - 1) / kCBlk, n_chunks);
  } else {
    const int n_mt = (4 * C + 15) / 16;
    const int n_kt = (9 * (Cx + C) + 15) / 16;
    if (dtype == 0)
      dwt_fma_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const float*>(h_prev), static_cast<const float*>(x_pad),
          static_cast<const float*>(dg), w, B, H, W, C, Cx, n_mt, n_kt,
          n_chunks);
    else
      dwt_fma_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(h_prev),
          static_cast<const __nv_bfloat16*>(x_pad),
          static_cast<const __nv_bfloat16*>(dg), w, B, H, W, C, Cx, n_mt,
          n_kt, n_chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)4 * C * 9 * (Cx + C);
  const int threads = 256;
  const long long rblocks = (n + threads - 1) / threads;
  if (dtype == 0)
    reduce_kernel<float><<<(unsigned)rblocks, threads, 0, s>>>(
        w, static_cast<float*>(dwt), n_chunks, n);
  else
    reduce_kernel<__nv_bfloat16><<<(unsigned)rblocks, threads, 0, s>>>(
        w, static_cast<__nv_bfloat16*>(dwt), n_chunks, n);
  return (int)cudaGetLastError();
}
