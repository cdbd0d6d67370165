// Fused ConvLSTM decode cell for Hopper (sm_90a): implicit-GEMM gate
// convolution with the LSTM update fused into its epilogue.
//
// Replaces: rsis_tpu/ops/pallas_decode.py::_fused_cell_rowmajor (kernel
// bodies _cell_kernel and _cell_kernel_dyfold). One kernel covers both: the
// dy-fold variant, the lane packing (pack = 128 // W) and the 2-row aligned
// halo blocks only fitted the work to the TPU's 128-row matrix unit and its
// (8, 128) tiles.
//
// Computes, for tensors stored (B, H, C, W):
//   gates = conv3x3_same([x_pad (Cx) || h_prev (C)], W) + S     (4C, fp32)
//   c = sig(f) * c_prev + sig(i) * tanh(g);  h = sig(o) * tanh(c)
// with gate order i, f, o, g. x_pad (B, H+2, Cx, W+2) carries its zero
// halo already; h_prev is unpadded and its SAME halo is zero (not a clamp).
// wt is the packed (4C, 9(Cx+C)) weight of pack_cell_weights: the 9 x taps
// first (tap-major, channel-minor), then the 9 h taps. Cx == 0 (cell 0)
// means there is no x input.
//
// What bounds it on the card: at the decode shapes (4C <= 512,
// K = 9(Cx+C) <= 1728) the gate conv is about 1.8 GFLOP per image per
// cell against 1-21 MB of inputs and outputs, so on the tensor cores it is
// bound by device-memory bytes (S, x_pad, h/c in and out).
//
// Design against that bound: the 4C gates of a pixel and the im2col taps
// never reach device memory. One block owns one output row of one image,
// a tile of tw columns, and ALL 4C gate channels of those pixels, so the
// LSTM epilogue runs on the accumulators in registers. The 3-row halo of
// x_pad and h_prev for the tile (all Cx + C channels) is staged once in
// shared memory (stage_halo: coalesced along W, 8 loads in flight per
// thread); S, c_prev, h and c are read and written once. Two main loops:
//   - bf16 with C and Cx multiples of 8 (every cell at hidden 128): an
//     implicit GEMM on the tensor cores, mma.sync m16n8k16 with fp32
//     accumulation, A by ldmatrix from the channel-minor halo and B pairs
//     from the packed weight, prefetched one k-step ahead;
//   - otherwise (fp32, small widths): fp32 FMA on CUDA cores, each thread
//     owning G channels x 4 gates x P pixels.
// Both keep the products exact in fp32 for bf16 inputs, as the plain
// version does. wgmma/TMA and a pipelined weight stage are later work.

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

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

constexpr int kThreads = 256;
constexpr int kInFlight = 8;  // halo loads a thread keeps in flight

// Stage the halo of output rows y .. y + rows - 3: for dy < rows, channel
// ch < Cx + C and tile column col < twp, calls store(dy, ch, col, v) with
//   ch <  Cx: x_pad[b, y + dy, ch, x0 + col]   (0 past row H + 1, col W + 1)
//   ch >= Cx: h_prev[b, y + dy - 1, ch - Cx, x0 + col - 1]  (0 outside)
// Consecutive threads read consecutive columns; each thread steps its
// (dy, ch, col) counters without division and keeps kInFlight loads in
// flight before storing.
template <typename T, typename Store>
__device__ __forceinline__ void stage_halo(const T* __restrict__ h_prev,
                                           const T* __restrict__ x_pad,
                                           int b, int y, int x0, int H, int W,
                                           int C, int Cx, int twp,
                                           int rows, Store store) {
  const int cn = Cx + C;
  const int dcol = blockDim.x % twp;
  const int dch = blockDim.x / twp;
  int col = threadIdx.x % twp;
  int ch = threadIdx.x / twp;
  int dy = 0;
  while (ch >= cn) {
    ch -= cn;
    ++dy;
  }
  while (dy < rows) {
    T v[kInFlight];
    int cols[kInFlight], chs[kInFlight], dys[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      cols[u] = col;
      chs[u] = ch;
      dys[u] = dy;
      T val = from_f<T>(0.0f);
      if (dy < rows) {
        if (ch < Cx) {
          const int px = x0 + col;
          if (px < W + 2 && y + dy < H + 2)
            val = x_pad[((size_t)(b * (H + 2) + y + dy) * Cx + ch) * (W + 2) +
                        px];
        } else {
          const int iy = y + dy - 1;
          const int ix = x0 + col - 1;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            val = h_prev[((size_t)(b * H + iy) * C + (ch - Cx)) * W + ix];
        }
      }
      v[u] = val;
      col += dcol;
      ch += dch;
      if (col >= twp) {
        col -= twp;
        ++ch;
      }
      while (ch >= cn) {
        ch -= cn;
        ++dy;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (dys[u] < rows) store(dys[u], chs[u], cols[u], v[u]);
  }
}

// One block: image b, output row y, columns [x0, x0 + tw). Threads are
// (C / G) channel groups x (tw / P) pixel groups; thread t owns channels
// cg*G .. cg*G+G-1 and pixels pg + j * (tw / P), j < P.
template <typename T, int G, int P>
__global__ void __launch_bounds__(kThreads)
fused_cell_kernel(const T* __restrict__ h_prev, const T* __restrict__ x_pad,
                  const T* __restrict__ c_prev, const T* __restrict__ s_term,
                  const T* __restrict__ wt, T* __restrict__ h_out,
                  T* __restrict__ c_out, int H, int W, int C, int Cx, int tw,
                  int n_tiles) {
  extern __shared__ float tile[];  // [3 rows][Cx + C channels][tw + 2 cols]
  const int cn = Cx + C;
  const int twp = tw + 2;
  const int K = 9 * cn;
  const int pgs = tw / P;
  const int xt = blockIdx.x % n_tiles;
  const int y = (blockIdx.x / n_tiles) % H;
  const int b = blockIdx.x / (n_tiles * H);
  const int x0 = xt * tw;

  // tile column j is x_pad column x0 + j (padded coordinates) and h
  // column x0 + j - 1
  stage_halo(h_prev, x_pad, b, y, x0, H, W, C, Cx, twp, 3,
             [&](int dy, int ch, int col, T v) {
               tile[(dy * cn + ch) * twp + col] = to_f(v);
             });
  __syncthreads();

  const int pg = threadIdx.x % pgs;
  const int cg = threadIdx.x / pgs;
  // row (gate * C + cg * G + gi) of wt starts at wbase + (gate * C + gi) * K
  const T* wbase = wt + (size_t)(cg * G) * K;

  float acc[4][G][P];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int j = 0; j < P; ++j) acc[q][gi][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    const float* trow = tile + (size_t)(dy * cn) * twp + dx + pg;
    for (int ch = 0; ch < cn; ++ch) {
      // packed column: x taps first, then h taps
      const int k = ch < Cx ? tap * Cx + ch : 9 * Cx + tap * C + (ch - Cx);
      const float* src = trow + (size_t)ch * twp;
      float in[P];
#pragma unroll
      for (int j = 0; j < P; ++j) in[j] = src[j * pgs];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float w = to_f(wbase[(size_t)(q * C + gi) * K + k]);
#pragma unroll
          for (int j = 0; j < P; ++j) acc[q][gi][j] = fmaf(w, in[j], acc[q][gi][j]);
        }
    }
  }

  const size_t row = (size_t)b * H + y;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int c = cg * G + gi;
    const T* s = s_term + (row * 4 * C + c) * W;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int x = x0 + pg + j * pgs;
      if (x >= W) continue;
      const float ig = sigmoid_f(acc[0][gi][j] + to_f(s[x]));
      const float fg = sigmoid_f(acc[1][gi][j] + to_f(s[(size_t)C * W + x]));
      const float og =
          sigmoid_f(acc[2][gi][j] + to_f(s[(size_t)2 * C * W + x]));
      const float gg = tanhf(acc[3][gi][j] + to_f(s[(size_t)3 * C * W + x]));
      const size_t o = (row * C + c) * W + x;
      const float c_new = fg * to_f(c_prev[o]) + ig * gg;
      h_out[o] = from_f<T>(og * tanhf(c_new));
      c_out[o] = from_f<T>(c_new);
    }
  }
}

// ---- bf16 tensor-core main loop --------------------------------------
//
// The same cell as an implicit GEMM D[pixel, n] = sum_k A[pixel, k] B[k, n]
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate). K walks groups of 8
// consecutive packed columns; each group is 8 channels of one tap (x or
// h), so A rows come from the shared-memory halo by ldmatrix and B pairs
// straight from the packed weight (K x N column-major = wt row-major).
// A warp owns 16 pixels and J blocks of 8 channels, i.e. 4J n-tiles: one
// per gate for each block, so a lane ends up holding i, f, o and g of the
// same (pixel, channel) pairs and the LSTM update runs on the fragments.
// Needs C and Cx to be multiples of 8.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4],
                                            const void* smem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Shared-memory tap halo: [R + 2 rows][tw + 2 cols][stride], channel-minor
// bf16, x channels then h channels. stride / 8 is odd so the 8 rows of an
// ldmatrix hit 8 different 16-byte bank groups.
__host__ __device__ inline int mma_stride(int cn) {
  const int units = cn / 8;
  return 8 * (units % 2 ? units : units + 1);
}

// One block: image b, output rows y0 .. y0 + R - 1, columns [x0, x0 + tw),
// tw = 16 * wm; the R + 2 halo rows are staged once for the R rows.
// Warp w: m-tile w % wm, channel blocks (w / wm) * J .. + J - 1.
template <int J>
__global__ void __launch_bounds__(kThreads)
fused_cell_mma_kernel(const __nv_bfloat16* __restrict__ h_prev,
                      const __nv_bfloat16* __restrict__ x_pad,
                      const __nv_bfloat16* __restrict__ c_prev,
                      const __nv_bfloat16* __restrict__ s_term,
                      const __nv_bfloat16* __restrict__ wt,
                      __nv_bfloat16* __restrict__ h_out,
                      __nv_bfloat16* __restrict__ c_out, int H, int W, int C,
                      int Cx, int wm, int R, int n_tiles) {
  extern __shared__ __align__(16) __nv_bfloat16 halo[];
  const int cn = Cx + C;
  const int stride = mma_stride(cn);
  const int tw = 16 * wm;
  const int twp = tw + 2;
  const int K = 9 * cn;
  const int n_row_groups = (H + R - 1) / R;
  const int xt = blockIdx.x % n_tiles;
  const int y0 = (blockIdx.x / n_tiles) % n_row_groups * R;
  const int b = blockIdx.x / (n_tiles * n_row_groups);
  const int x0 = xt * tw;

  const int xg = Cx / 8;            // x groups per tap
  const int hg = C / 8;             // h groups per tap
  const int n_groups = 9 * (xg + hg);
  // k8 group g (packed columns 8g .. 8g+7) -> its halo offset for pixel 0
  int* goff = reinterpret_cast<int*>(halo + (R + 2) * twp * stride);
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    int tap, chs;
    if (g < 9 * xg) {
      tap = g / xg;
      chs = (g % xg) * 8;
    } else {
      tap = (g - 9 * xg) / hg;
      chs = Cx + ((g - 9 * xg) % hg) * 8;
    }
    goff[g] = ((tap / 3) * twp + tap % 3) * stride + chs;
  }
  stage_halo(h_prev, x_pad, b, y0, x0, H, W, C, Cx, twp, R + 2,
             [&](int dy, int ch, int col, __nv_bfloat16 v) {
               halo[(dy * twp + col) * stride + ch] = v;
             });
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mt = warp % wm;
  const int jb0 = (warp / wm) * J;

  // this lane's ldmatrix row: pixel mt*16 + r, group half (lane >> 4)
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int half = lane >> 4;

  // weight pair pointers: row n = q*C + (jb0+j)*8 + lane/4, column
  // 8*g + 2*(lane%4)
  const __nv_bfloat16* wrow =
      wt + (size_t)(jb0 * 8 + (lane >> 2)) * K + 2 * (lane & 3);

  // B pairs of k-step g0 (groups g0, g0 + 1); the next step's are loaded
  // before this step's products so their L2 latency overlaps the math
  auto load_b = [&](unsigned (&dst)[J][4][2], int g0) {
    const bool has_g1 = g0 + 1 < n_groups;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat16* wp = wrow + (size_t)(q * C + j * 8) * K;
        dst[j][q][0] = *reinterpret_cast<const unsigned*>(wp + 8 * g0);
        dst[j][q][1] =
            has_g1 ? *reinterpret_cast<const unsigned*>(wp + 8 * (g0 + 1))
                   : 0u;
      }
  };
  for (int rr = 0; rr < R && y0 + rr < H; ++rr) {
    float acc[J][4][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.0f;

    unsigned bcur[J][4][2];
    load_b(bcur, 0);
    const __nv_bfloat16* arow =
        halo + (size_t)(rr * twp + mt * 16 + r) * stride;
    for (int g0 = 0; g0 < n_groups; g0 += 2) {
      unsigned bnext[J][4][2];
      const bool more = g0 + 2 < n_groups;
      if (more) load_b(bnext, g0 + 2);
      const bool has_g1 = g0 + 1 < n_groups;
      unsigned a[4];
      ldmatrix_x4(a, arow + goff[(half && has_g1) ? g0 + 1 : g0]);
      if (!has_g1) a[2] = a[3] = 0u;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_bf16(acc[j][q], a, bcur[j][q][0], bcur[j][q][1]);
      if (more) {
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            bcur[j][q][0] = bnext[j][q][0];
            bcur[j][q][1] = bnext[j][q][1];
          }
      }
    }

    const size_t row = (size_t)b * H + y0 + rr;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (jb0 + j) * 8 + 2 * (lane & 3) + (e & 1);
        const int x = x0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        if (x >= W) continue;
        const __nv_bfloat16* s = s_term + (row * 4 * C + c) * W + x;
        const float ig = sigmoid_f(acc[j][0][e] + to_f(s[0]));
        const float fg = sigmoid_f(acc[j][1][e] + to_f(s[(size_t)C * W]));
        const float og = sigmoid_f(acc[j][2][e] + to_f(s[(size_t)2 * C * W]));
        const float gg = tanhf(acc[j][3][e] + to_f(s[(size_t)3 * C * W]));
        const size_t o = (row * C + c) * W + x;
        const float c_new = fg * to_f(c_prev[o]) + ig * gg;
        h_out[o] = __float2bfloat16_rn(og * tanhf(c_new));
        c_out[o] = __float2bfloat16_rn(c_new);
      }
  }
}

// Launches the tensor-core kernel when the shapes allow it; returns
// cudaErrorNotSupported when they do not (the caller then takes the FMA
// kernel).
template <int J>
cudaError_t launch_mma(const void* h_prev, const void* x_pad,
                       const void* c_prev, const void* s_term, const void* wt,
                       void* h_out, void* c_out, int B, int H, int W, int C,
                       int Cx, cudaStream_t stream) {
  const int wn = C / 8 / J;        // warps along the gate channels
  if (wn < 1 || wn > kThreads / 32) return cudaErrorNotSupported;
  int wm = kThreads / 32 / wn;     // warps (m-tiles of 16) along W
  const int need = (W + 15) / 16;
  if (wm > need) wm = need;
  const int tw = 16 * wm;
  const int n_tiles = (W + tw - 1) / tw;
  // rows per block: 4 while that leaves at least 2 blocks per SM (132)
  int R = 4;
  while (R > 1 && (long long)B * ((H + R - 1) / R) * n_tiles < 264) R /= 2;
  size_t smem = 0;
  while (true) {
    smem = (size_t)(R + 2) * (tw + 2) * mma_stride(Cx + C) *
               sizeof(__nv_bfloat16) +
           (size_t)9 * (Cx + C) / 8 * sizeof(int);
    if (smem <= 227 * 1024 || R == 1) break;
    R /= 2;
  }
  if (smem > 227 * 1024) return cudaErrorNotSupported;
  auto kern = fused_cell_mma_kernel<J>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((H + R - 1) / R) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  kern<<<(unsigned)blocks, 32 * wm * wn, smem, stream>>>(
      static_cast<const bf*>(h_prev), static_cast<const bf*>(x_pad),
      static_cast<const bf*>(c_prev), static_cast<const bf*>(s_term),
      static_cast<const bf*>(wt), static_cast<bf*>(h_out),
      static_cast<bf*>(c_out), H, W, C, Cx, wm, R, n_tiles);
  return cudaGetLastError();
}

template <typename T, int G, int P>
cudaError_t launch(const void* h_prev, const void* x_pad, const void* c_prev,
                   const void* s_term, const void* wt, void* h_out,
                   void* c_out, int B, int H, int W, int C, int Cx,
                   cudaStream_t stream) {
  const int cgs = C / G;
  if (cgs > kThreads) return cudaErrorInvalidValue;
  // pixel groups per block: fill kThreads threads, but not past W
  int pgs = kThreads / cgs;
  const int need = (W + P - 1) / P;
  if (pgs > need) pgs = need;
  const int cn = Cx + C;
  size_t smem = 0;
  while (true) {
    smem = (size_t)3 * cn * (pgs * P + 2) * sizeof(float);
    if (smem <= 227 * 1024 || pgs == 1) break;
    pgs /= 2;
  }
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const int tw = pgs * P;
  const int n_tiles = (W + tw - 1) / tw;
  auto kern = fused_cell_kernel<T, G, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, pgs * cgs, smem, stream>>>(
      static_cast<const T*>(h_prev), static_cast<const T*>(x_pad),
      static_cast<const T*>(c_prev), static_cast<const T*>(s_term),
      static_cast<const T*>(wt), static_cast<T*>(h_out),
      static_cast<T*>(c_out), H, W, C, Cx, tw, n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* h_prev, const void* x_pad,
                     const void* c_prev, const void* s_term, const void* wt,
                     void* h_out, void* c_out, int B, int H, int W, int C,
                     int Cx, cudaStream_t stream) {
  if (C % 2 == 0)
    return launch<T, 2, 4>(h_prev, x_pad, c_prev, s_term, wt, h_out, c_out, B,
                           H, W, C, Cx, stream);
  return launch<T, 1, 8>(h_prev, x_pad, c_prev, s_term, wt, h_out, c_out, B,
                         H, W, C, Cx, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor in the same dtype).
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_fused_cell(const void* h_prev, const void* x_pad,
                               const void* c_prev, const void* s_term,
                               const void* wt, void* h_out, void* c_out,
                               int B, int H, int W, int C, int Cx, int dtype,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cx < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(h_prev, x_pad, c_prev, s_term, wt, h_out, c_out, B,
                          H, W, C, Cx, s);
  else if (dtype == 1) {
    err = cudaErrorNotSupported;
    if (C % 8 == 0 && Cx % 8 == 0)
      err = (C / 8) % 2 == 0
                ? launch_mma<2>(h_prev, x_pad, c_prev, s_term, wt, h_out,
                                c_out, B, H, W, C, Cx, s)
                : launch_mma<1>(h_prev, x_pad, c_prev, s_term, wt, h_out,
                                c_out, B, H, W, C, Cx, s);
    if (err == cudaErrorNotSupported)
      err = dispatch<__nv_bfloat16>(h_prev, x_pad, c_prev, s_term, wt, h_out,
                                    c_out, B, H, W, C, Cx, s);
  } else
    err = cudaErrorInvalidValue;
  return (int)err;
}
