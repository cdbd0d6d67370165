// Fused mask head for Hopper (sm_90a): conv3x3 -> 1 channel of the
// align-corners 2x bilinear upsample of the finest hidden state, + bias.
//
// Replaces: rsis_tpu/ops/pallas_mask_head.py::_head_call (kernel bodies
// _head_kernel and _head_kernel_vpu). One kernel covers both tails: the
// dense column-interpolation matmul, the lane rolls and the int32 packing
// of bf16 pairs only fitted the TPU's matrix unit and its 32-bit lanes.
//
// Computes, for h stored (B, H, C, W) and output (B, 2H, 2W):
//   out[oy, ox] = bias + sum_{dy,dx,c} k[dy,dx,c] * U(h_c)[oy+dy-1, ox+dx-1]
// where U is the align-corners 2x interpolation and the conv's SAME
// padding is zero OUTSIDE the upsampled grid (not a clamp of the input).
// U has two taps per axis with closed-form phase weights (n = H or W):
//   U[2m]   = a[m] z[m-1] + (1 - a[m]) z[m],    a[m] = m / (2n - 1)
//   U[2m+1] = (1 - d[m]) z[m] + d[m] z[m+1],    d[m] = (n - 1 - m) / (2n - 1)
// a[0] = 0 and d[n-1] = 0, so the zero-filled rows/columns just outside
// the image never contribute; the only out-of-range upsampled rows and
// columns (-1 and 2n) get weight 0 explicitly.
//
// What bounds it on the card: device-memory bytes. Per image it reads
// H*W*C input values and writes 4*H*W outputs (2.1 MB in, 1.0 MB out at
// 256x512x8 bf16) for about 10 FLOP per input value.
//
// Design against that bound: every intermediate stays on chip, so device
// memory sees each input once and each output once. A block owns an
// (8 input rows x 64 input columns) tile and its (16 x 128) output tile;
// it first tabulates the interpolation weights of its output rows and
// columns (no divisions in the stages), then:
//   1. channels first: the 9 tap planes z_t = sum_c k9[t, c] * h_c over the
//      (8 + 2) x (64 + 2) halo, read coalesced along W, into shared memory;
//   2. the banded 2-tap row interpolation with the conv's row shift, summed
//      over dy (9 planes -> 3), into shared memory;
//   3. the banded 2-tap column interpolation with the dx shift, summed over
//      dx, plus bias, written coalesced along 2W.
// Everything accumulates in fp32 and rounds once to the output dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
constexpr int TH = 8;         // input rows per block
constexpr int TWC = 64;       // input columns per block
constexpr int ZR = TH + 2;    // halo rows
constexpr int ZC = TWC + 2;   // halo columns
constexpr int OR = 2 * TH;    // output rows per block
constexpr int OC = 2 * TWC;   // output columns per block

// Upsampled position p of an n-long axis as wa * z[m] + wb * z[m + 1].
__device__ __forceinline__ void phase(int p, int n, int& m, float& wa,
                                      float& wb) {
  const float denom = (float)(2 * n - 1);
  const int half = p >> 1;
  if (p & 1) {
    m = half;
    const float d = (float)(n - 1 - half) / denom;
    wa = 1.0f - d;
    wb = d;
  } else {
    m = half - 1;
    const float a = (float)half / denom;
    wa = a;
    wb = 1.0f - a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_head_kernel(const T* __restrict__ hs, const float* __restrict__ k9,
                 const float* __restrict__ bias, T* __restrict__ out, int H,
                 int C, int W, int n_row_tiles, int n_col_tiles) {
  __shared__ float z[9][ZR][ZC];
  __shared__ float yd[3][OR][ZC];
  // per-block interpolation tables: for output row o (column q) and tap
  // dy (dx), U = wa * v[lo] + wb * v[lo + 1] in block-local halo indices;
  // wa = wb = 0 where the conv reads outside the upsampled grid
  __shared__ int row_lo[3][OR];
  __shared__ float row_wa[3][OR], row_wb[3][OR];
  __shared__ int col_lo[3][OC];
  __shared__ float col_wa[3][OC], col_wb[3][OC];
  extern __shared__ float kw[];  // (9, C) tap weights
  const int ct = blockIdx.x % n_col_tiles;
  const int rt = (blockIdx.x / n_col_tiles) % n_row_tiles;
  const int b = blockIdx.x / (n_col_tiles * n_row_tiles);
  const int r0 = rt * TH;
  const int x0 = ct * TWC;

  for (int i = threadIdx.x; i < 9 * C; i += blockDim.x) kw[i] = k9[i];
  for (int i = threadIdx.x; i < 3 * (OR + OC); i += blockDim.x) {
    const bool is_row = i < 3 * OR;
    const int k = is_row ? i : i - 3 * OR;
    const int len = is_row ? OR : OC;
    const int tap = k / len, o = k % len;
    const int n = is_row ? H : W;
    const int p = (is_row ? 2 * r0 : 2 * x0) + o + tap - 1;
    int m = 0;
    float wa = 0.0f, wb = 0.0f;
    if (p >= 0 && p < 2 * n) {
      phase(p, n, m, wa, wb);
      m -= (is_row ? r0 : x0) - 1;
    }
    if (is_row) {
      row_lo[tap][o] = m;
      row_wa[tap][o] = wa;
      row_wb[tap][o] = wb;
    } else {
      col_lo[tap][o] = m;
      col_wa[tap][o] = wa;
      col_wb[tap][o] = wb;
    }
  }
  __syncthreads();

  // 1. channel contraction over the halo; z row r is input row r0 - 1 + r,
  //    column j is input column x0 - 1 + j (zero outside the image)
  for (int i = threadIdx.x; i < ZR * ZC; i += blockDim.x) {
    const int r = i / ZC;
    const int j = i % ZC;
    const int m = r0 - 1 + r;
    const int n = x0 - 1 + j;
    float a[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) a[t] = 0.0f;
    if (m >= 0 && m < H && n >= 0 && n < W) {
      const T* src = hs + (size_t)(b * H + m) * C * W + n;
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        const float v = to_f(src[(size_t)c * W]);
#pragma unroll
        for (int t = 0; t < 9; ++t) a[t] = fmaf(kw[t * C + c], v, a[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) z[t][r][j] = a[t];
  }
  __syncthreads();

  // 2. row interpolation + the conv's row shift, summed over dy:
  //    yd[dx][o][j] = sum_dy U_rows(z_{dy,dx})[2 r0 + o + dy - 1][j]
  for (int i = threadIdx.x; i < 3 * OR * ZC; i += blockDim.x) {
    const int j = i % ZC;
    const int o = (i / ZC) % OR;
    const int dx = i / (ZC * OR);
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int lr = row_lo[dy][o];
      acc += row_wa[dy][o] * z[dy * 3 + dx][lr][j] +
             row_wb[dy][o] * z[dy * 3 + dx][lr + 1][j];
    }
    yd[dx][o][j] = acc;
  }
  __syncthreads();

  // 3. column interpolation + the dx shift, summed over dx, + bias
  const float b0 = bias[0];
  for (int i = threadIdx.x; i < OR * OC; i += blockDim.x) {
    const int q = i % OC;
    const int o = i / OC;
    const int oy = 2 * r0 + o;
    const int ox = 2 * x0 + q;
    if (oy >= 2 * H || ox >= 2 * W) continue;
    float acc = b0;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int lc = col_lo[dx][q];
      acc += col_wa[dx][q] * yd[dx][o][lc] + col_wb[dx][q] * yd[dx][o][lc + 1];
    }
    out[((size_t)b * 2 * H + oy) * 2 * W + ox] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* hs, const float* k9, const float* bias,
                   void* out, int B, int H, int C, int W,
                   cudaStream_t stream) {
  const int n_row_tiles = (H + TH - 1) / TH;
  const int n_col_tiles = (W + TWC - 1) / TWC;
  const size_t smem = (size_t)9 * C * sizeof(float);
  const size_t static_smem = sizeof(float) * (9 * ZR * ZC + 3 * OR * ZC) +
                             3 * (OR + OC) * (sizeof(int) + 2 * sizeof(float));
  if (smem + static_smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = mask_head_kernel<T>;
  if (smem + static_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)B * n_row_tiles * n_col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(hs), k9, bias, static_cast<T*>(out), H, C, W,
      n_row_tiles, n_col_tiles);
  return cudaGetLastError();
}

}  // namespace

// hs (B, H, C, W) and out (B, 2H, 2W) in dtype (0 = float32,
// 1 = bfloat16); k9 (9, C) float32 tap weights (tap = dy * 3 + dx); bias
// one float32. Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_mask_head(const void* hs, const void* k9,
                              const void* bias, void* out, int B, int H,
                              int C, int W, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k9);
  const float* bf = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(hs, kf, bf, out, B, H, C, W, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(hs, kf, bf, out, B, H, C, W, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
