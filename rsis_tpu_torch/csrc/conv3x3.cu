// Plain 3x3 SAME convolution in the (B, H, C, W) layout for Hopper
// (sm_90a), with packed weights.
//
// Replaces: rsis_tpu/ops/pallas_decode.py::_conv3x3_rowmajor (kernel
// bodies _conv_kernel and _conv_kernel_dyfold). In the training step it
// pulls the gate cotangents back through the cell's gate convolution: the
// input is dg (B, H, 4C, W) and the weight the flipped, transposed cell
// weight, so Cin = 4C (512 ... 32) and Cout = Cx + C (128, 192, 96, 48,
// 24 at hidden 128).
//
// Computes out[b, y, co, x] = sum_{tap, ci} wt[co, tap * Cin + ci] *
// in[b, y + tap / 3 - 1, ci, x + tap % 3 - 1] (zero outside the image),
// accumulated in fp32 and stored once in the input dtype.
//
// What bounds it on the card: 2 * Cout * 9 * Cin operations per pixel
// (up to 1.8 GFLOP per image per cell) against dg read once and Cx + C
// channels written once; on the tensor cores the bytes bound it.
//
// Design: the gate kernel's implicit GEMM without its epilogue. One block
// owns R output rows of one image and a tile of columns; the R + 2 halo
// rows of all Cin channels are staged once in shared memory
// (cell_common.cuh::stage_halo, zero halo); a warp owns 16 pixels and NT
// n-tiles of 8 output channels, so Cout = 24 and 48 (multiples of 8, not
// of 16) need no padded weight. bf16 with Cin and Cout multiples of 8 runs
// mma.sync m16n8k16 (fp32 accumulation); everything else an fp32 FMA loop.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::kMaxSmem;
using rsis::kThreads;
using rsis::mma_stride;
using rsis::to_f;

// One block: image b, output rows y0 .. y0 + R - 1, columns [x0, x0 + tw),
// tw = 16 * wm. Warp w: m-tile w % wm, n-tiles (w / wm) * NT .. + NT - 1.
template <int NT>
__global__ void __launch_bounds__(kThreads)
conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wt,
                __nv_bfloat16* __restrict__ out, int H, int W, int Cin,
                int Cout, int wm, int R, int n_tiles) {
  extern __shared__ __align__(16) __nv_bfloat16 halo[];
  const int stride = mma_stride(Cin);
  const int tw = 16 * wm;
  const int twp = tw + 2;
  const int K = 9 * Cin;
  const int n_row_groups = (H + R - 1) / R;
  const int xt = blockIdx.x % n_tiles;
  const int y0 = (blockIdx.x / n_tiles) % n_row_groups * R;
  const int b = blockIdx.x / (n_tiles * n_row_groups);
  const int x0 = xt * tw;

  const int n_groups = 9 * (Cin / 8);
  int* goff = reinterpret_cast<int*>(halo + (R + 2) * twp * stride);
  rsis::fill_group_offsets(goff, 0, Cin / 8, 0, twp, stride);
  rsis::stage_halo(x, x, b, y0, x0, H, W, Cin, 0, twp, R + 2,
                   [&](int dy, int ch, int col, __nv_bfloat16 v) {
                     halo[(dy * twp + col) * stride + ch] = v;
                   });
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mt = warp % wm;
  const int nb0 = (warp / wm) * NT;
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int half = lane >> 4;
  // weight pair pointer: row n = (nb0 + t) * 8 + lane / 4, column
  // 8 * g + 2 * (lane % 4)
  const __nv_bfloat16* wrow =
      wt + (size_t)(nb0 * 8 + (lane >> 2)) * K + 2 * (lane & 3);

  auto load_b = [&](unsigned (&dst)[NT][2], int g0) {
    const bool has_g1 = g0 + 1 < n_groups;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat16* wp = wrow + (size_t)(t * 8) * K;
      dst[t][0] = *reinterpret_cast<const unsigned*>(wp + 8 * g0);
      dst[t][1] = has_g1
                      ? *reinterpret_cast<const unsigned*>(wp + 8 * (g0 + 1))
                      : 0u;
    }
  };
  for (int rr = 0; rr < R && y0 + rr < H; ++rr) {
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
    unsigned bcur[NT][2];
    load_b(bcur, 0);
    const __nv_bfloat16* arow =
        halo + (size_t)(rr * twp + mt * 16 + r) * stride;
    for (int g0 = 0; g0 < n_groups; g0 += 2) {
      unsigned bnext[NT][2];
      const bool more = g0 + 2 < n_groups;
      if (more) load_b(bnext, g0 + 2);
      const bool has_g1 = g0 + 1 < n_groups;
      unsigned a[4];
      rsis::ldmatrix_x4(a, arow + goff[(half && has_g1) ? g0 + 1 : g0]);
      if (!has_g1) a[2] = a[3] = 0u;
#pragma unroll
      for (int t = 0; t < NT; ++t) rsis::mma_bf16(acc[t], a, bcur[t][0],
                                                  bcur[t][1]);
      if (more) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          bcur[t][0] = bnext[t][0];
          bcur[t][1] = bnext[t][1];
        }
      }
    }
    const size_t row = (size_t)b * H + y0 + rr;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = (nb0 + t) * 8 + 2 * (lane & 3) + (e & 1);
        const int px = x0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        if (px < W) out[(row * Cout + co) * W + px] = __float2bfloat16_rn(
            acc[t][e]);
      }
  }
}

// One block: image b, output row y, columns [x0, x0 + tw). Threads are
// ceil(Cout / G) channel groups x (tw / P) pixel groups.
template <typename T, int G, int P>
__global__ void __launch_bounds__(kThreads)
conv_fma_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                T* __restrict__ out, int H, int W, int Cin, int Cout, int tw,
                int n_tiles) {
  extern __shared__ float tile[];  // [3 rows][Cin][tw + 2 cols]
  const int twp = tw + 2;
  const int K = 9 * Cin;
  const int pgs = tw / P;
  const int xt = blockIdx.x % n_tiles;
  const int y = (blockIdx.x / n_tiles) % H;
  const int b = blockIdx.x / (n_tiles * H);
  const int x0 = xt * tw;
  rsis::stage_halo(x, x, b, y, x0, H, W, Cin, 0, twp, 3,
                   [&](int dy, int ch, int col, T v) {
                     tile[(dy * Cin + ch) * twp + col] = to_f(v);
                   });
  __syncthreads();

  const int pg = threadIdx.x % pgs;
  const int cg = threadIdx.x / pgs;
  float acc[G][P];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < P; ++j) acc[gi][j] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const float* trow = tile + (size_t)(tap / 3 * Cin) * twp + tap % 3 + pg;
    for (int ci = 0; ci < Cin; ++ci) {
      const float* src = trow + (size_t)ci * twp;
      float in[P];
#pragma unroll
      for (int j = 0; j < P; ++j) in[j] = src[j * pgs];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int co = cg * G + gi;
        const float w =
            co < Cout ? to_f(wt[(size_t)co * K + tap * Cin + ci]) : 0.0f;
#pragma unroll
        for (int j = 0; j < P; ++j) acc[gi][j] = fmaf(w, in[j], acc[gi][j]);
      }
    }
  }
  const size_t row = (size_t)b * H + y;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int co = cg * G + gi;
    if (co >= Cout) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int px = x0 + pg + j * pgs;
      if (px < W) out[(row * Cout + co) * W + px] = from_f<T>(acc[gi][j]);
    }
  }
}

template <int NT>
cudaError_t launch_mma(const void* x, const void* wt, void* out, int B, int H,
                       int W, int Cin, int Cout, cudaStream_t stream) {
  const int wn = Cout / 8 / NT;   // warps along the output channels
  int wm = kThreads / 32 / wn;    // warps (m-tiles of 16) along W
  const int need = (W + 15) / 16;
  if (wm > need) wm = need;
  const int tw = 16 * wm;
  const int n_tiles = (W + tw - 1) / tw;
  int R = 4;
  while (R > 1 && (long long)B * ((H + R - 1) / R) * n_tiles < 264) R /= 2;
  size_t smem = 0;
  while (true) {
    smem = (size_t)(R + 2) * (tw + 2) * mma_stride(Cin) *
               sizeof(__nv_bfloat16) +
           (size_t)9 * Cin / 8 * sizeof(int);
    if (smem <= kMaxSmem || R == 1) break;
    R /= 2;
  }
  if (smem > kMaxSmem) return cudaErrorNotSupported;
  auto kern = conv_mma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((H + R - 1) / R) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  kern<<<(unsigned)blocks, 32 * wm * wn, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(wt),
      static_cast<bf*>(out), H, W, Cin, Cout, wm, R, n_tiles);
  return cudaGetLastError();
}

// n-tiles of 8 output channels per warp: the largest NT that divides
// Cout / 8 with at most 8 warps along the channels.
cudaError_t dispatch_mma(const void* x, const void* wt, void* out, int B,
                         int H, int W, int Cin, int Cout,
                         cudaStream_t stream) {
  const int n8 = Cout / 8;
  auto fits = [&](int nt) { return n8 % nt == 0 && n8 / nt <= 8; };
  if (fits(8)) return launch_mma<8>(x, wt, out, B, H, W, Cin, Cout, stream);
  if (fits(6)) return launch_mma<6>(x, wt, out, B, H, W, Cin, Cout, stream);
  if (fits(4)) return launch_mma<4>(x, wt, out, B, H, W, Cin, Cout, stream);
  if (fits(3)) return launch_mma<3>(x, wt, out, B, H, W, Cin, Cout, stream);
  if (fits(2)) return launch_mma<2>(x, wt, out, B, H, W, Cin, Cout, stream);
  if (fits(1)) return launch_mma<1>(x, wt, out, B, H, W, Cin, Cout, stream);
  return cudaErrorNotSupported;
}

template <typename T, int G, int P>
cudaError_t launch_fma(const void* x, const void* wt, void* out, int B, int H,
                       int W, int Cin, int Cout, cudaStream_t stream) {
  const int cgs = (Cout + G - 1) / G;
  if (cgs > kThreads) return cudaErrorInvalidValue;
  int pgs = kThreads / cgs;
  const int need = (W + P - 1) / P;
  if (pgs > need) pgs = need;
  size_t smem = 0;
  while (true) {
    smem = (size_t)3 * Cin * (pgs * P + 2) * sizeof(float);
    if (smem <= kMaxSmem || pgs == 1) break;
    pgs /= 2;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int tw = pgs * P;
  const int n_tiles = (W + tw - 1) / tw;
  auto kern = conv_fma_kernel<T, G, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, pgs * cgs, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<T*>(out),
      H, W, Cin, Cout, tw, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, Cin, W), wt (Cout, 9 * Cin) tap-major, channel-minor, out
// (B, H, Cout, W); dtype: 0 = float32, 1 = bfloat16 (all three alike).
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_conv3x3(const void* x, const void* wt, void* out, int B,
                            int H, int W, int Cin, int Cout, int dtype,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fma<float, 4, 4>(x, wt, out, B, H, W, Cin, Cout, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorNotSupported;
  if (Cin % 8 == 0 && Cout % 8 == 0)
    err = dispatch_mma(x, wt, out, B, H, W, Cin, Cout, s);
  if (err == cudaErrorNotSupported)
    err = launch_fma<__nv_bfloat16, 4, 4>(x, wt, out, B, H, W, Cin, Cout, s);
  return (int)err;
}
