// Shared machinery of the ConvLSTM cell kernels (fused_cell.cu, the
// forward, cell_bwd.cu, the backward, and clstm_step.cu, the NCHW step):
// the halo staging, the mma.sync helpers and the gate convolution's two
// main loops, each with the epilogue and the operands' layout as template
// arguments; and the asynchronous staging helpers (cp.async, ldmatrix /
// stmatrix on shared addresses, the Walk counters) of weight_grad.cu and
// conv3x3.cu.
//
// The gate convolution, for tensors stored (B, H, C, W):
//   gates = conv3x3_same([x_pad (Cx) || h_prev (C)], W)          (4C, fp32)
// x_pad (B, H+2, Cx, W+2) carries its zero halo already; h_prev is
// unpadded and its SAME halo is zero (not a clamp). wt is the packed
// (4C, 9(Cx+C)) weight of pack_cell_weights: the 9 x taps first
// (tap-major, channel-minor), then the 9 h taps. Cx == 0 (cell 0) means
// there is no x input. The epilogue receives, for each (row = b * H + y,
// channel c, column x), the four gate sums i, f, o, g (without S) and does
// whatever the kernel is for: the LSTM update (forward) or the gate
// cotangents (backward). Both kernels therefore compute the same gate sums
// in the same order.
//
// Two main loops:
//   - bf16 with C and Cx multiples of 8 (every cell at hidden 128): an
//     implicit GEMM on the tensor cores, mma.sync m16n8k16 with fp32
//     accumulation, A by ldmatrix from the channel-minor halo and B pairs
//     from the packed weight, prefetched one k-step ahead;
//   - otherwise (fp32, small widths): fp32 FMA on CUDA cores, each thread
//     owning G channels x 4 gates x P pixels.
// Both keep the products exact in fp32 for bf16 inputs, as the plain
// versions do.
//
// Two operand layouts (the Layout template argument): RowMajorLayout is
// the one above (the decode's kernels); NchwLayout reads an unpadded NCHW
// x (B, Cx, H, W) and h_prev (B, C, H, W) with a zero SAME halo and the
// gate weight as OHWI (4C, 3, 3, Cx+C) (column tap * (Cx+C) + ch of a
// weight row), for the ConvLSTM step of clstm_step.cu. Both give the main
// loops the same concat-channel order (x channels, then h) and the same
// products in the same order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace rsis {

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
constexpr size_t kMaxSmem = 227 * 1024;

// The decode's (B, H, C, W) tensors: x_pad (B, H+2, Cx, W+2) with its zero
// ring, h_prev unpadded, the packed weight of pack_cell_weights.
struct RowMajorLayout {
  static constexpr bool kPackedWeight = true;
  // halo value at padded row py, padded column px, concat channel ch
  template <typename T>
  static __device__ __forceinline__ T halo(const T* __restrict__ h_prev,
                                           const T* __restrict__ x_pad,
                                           int b, int py, int ch, int px,
                                           int H, int W, int C, int Cx) {
    T val = from_f<T>(0.0f);
    if (ch < Cx) {
      if (px < W + 2 && py < H + 2)
        val = x_pad[((size_t)(b * (H + 2) + py) * Cx + ch) * (W + 2) + px];
    } else {
      const int iy = py - 1;
      const int ix = px - 1;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        val = h_prev[((size_t)(b * H + iy) * C + (ch - Cx)) * W + ix];
    }
    return val;
  }
  // column of a weight row for (tap, concat channel ch)
  static __device__ __forceinline__ int wcol(int tap, int ch, int C,
                                             int Cx) {
    return ch < Cx ? tap * Cx + ch : 9 * Cx + tap * C + (ch - Cx);
  }
};

// NCHW x (B, Cx, H, W) and h_prev (B, C, H, W), both unpadded with a zero
// SAME halo, and the OHWI weight (4C, 3, 3, Cx+C).
struct NchwLayout {
  static constexpr bool kPackedWeight = false;
  template <typename T>
  static __device__ __forceinline__ T halo(const T* __restrict__ h_prev,
                                           const T* __restrict__ x,
                                           int b, int py, int ch, int px,
                                           int H, int W, int C, int Cx) {
    T val = from_f<T>(0.0f);
    const int iy = py - 1;
    const int ix = px - 1;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      if (ch < Cx)
        val = x[((size_t)(b * Cx + ch) * H + iy) * W + ix];
      else
        val = h_prev[((size_t)(b * C + (ch - Cx)) * H + iy) * W + ix];
    }
    return val;
  }
  static __device__ __forceinline__ int wcol(int tap, int ch, int C,
                                             int Cx) {
    return tap * (Cx + C) + ch;
  }
};

// Stage the halo of output rows y .. y + rows - 3: for dy < rows, channel
// ch < Cx + C and tile column col < twp, calls store(dy, ch, col, v) with
// v = Layout::halo at padded row y + dy and padded column x0 + col; for
// RowMajorLayout that is
//   ch <  Cx: x_pad[b, y + dy, ch, x0 + col]   (0 past row H + 1, col W + 1)
//   ch >= Cx: h_prev[b, y + dy - 1, ch - Cx, x0 + col - 1]  (0 outside)
// Consecutive threads read consecutive columns; each thread steps its
// (dy, ch, col) counters without division and keeps kInFlight loads in
// flight before storing.
template <typename Layout = RowMajorLayout, typename T, typename Store>
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
      if (dy < rows)
        val = Layout::template halo<T>(h_prev, x_pad, b, y + dy, ch, x0 + col,
                                       H, W, C, Cx);
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

// ---- fp32 FMA main loop ------------------------------------------------
//
// One block: image b, output row y, columns [x0, x0 + tw). Threads are
// (C / G) channel groups x (tw / P) pixel groups; thread t owns channels
// cg*G .. cg*G+G-1 and pixels pg + j * (tw / P), j < P.
template <typename T, int G, int P, typename Layout, typename Epi>
__global__ void __launch_bounds__(kThreads)
cell_fma_kernel(const T* __restrict__ h_prev, const T* __restrict__ x_pad,
                const T* __restrict__ wt, int H, int W, int C, int Cx, int tw,
                int n_tiles, Epi epi) {
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
  stage_halo<Layout>(h_prev, x_pad, b, y, x0, H, W, C, Cx, twp, 3,
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
      // packed column: x taps first, then h taps (RowMajorLayout)
      const int k = Layout::wcol(tap, ch, C, Cx);
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
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int x = x0 + pg + j * pgs;
      if (x >= W) continue;
      epi(row, c, x, acc[0][gi][j], acc[1][gi][j], acc[2][gi][j],
          acc[3][gi][j]);
    }
  }
}

// ---- bf16 tensor-core main loop --------------------------------------
//
// The same gate sums as an implicit GEMM D[pixel, n] = sum_k A[pixel, k]
// B[k, n] with mma.sync m16n8k16 (bf16 in, fp32 accumulate). K walks
// groups of 8 consecutive packed columns; each group is 8 channels of one
// tap (x or h), so A rows come from the shared-memory halo by ldmatrix and
// B pairs straight from the packed weight (K x N column-major = wt
// row-major). A warp owns 16 pixels and J blocks of 8 channels, i.e. 4J
// n-tiles: one per gate for each block, so a lane ends up holding i, f, o
// and g of the same (pixel, channel) pairs and the epilogue runs on the
// fragments. Needs C and Cx to be multiples of 8.

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

// Transposed pair: lanes 0-7 address the rows of matrix 0 and lanes 8-15
// those of matrix 1; each lane receives two consecutive ROWS of one column
// (the B fragment of a k-major tile).
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&b)[2],
                                                  const void* smem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// ---- asynchronous staging (weight_grad.cu, conv3x3.cu) ----------------

// 16 bytes to shared memory, of which the first `bytes` from src and the
// rest zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&b)[4],
                                                  const void* smem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Lanes 8i .. 8i + 7 address the destination rows of matrix i; each row
// receives a column of the matrix that v[i] holds as ldmatrix gave it.
__device__ __forceinline__ void stmatrix_x4_trans(void* smem,
                                                  const unsigned (&v)[4]) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1,%2,%3,%4};\n" ::"r"(addr),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
      : "memory");
}

// A flat index i = (c * nb + b) * na + a over an (., nb, na) box, stepped
// by a fixed stride without division (the staging loops' counters).
struct Walk {
  int a, b, c, da, db, dc, na, nb;
  __device__ Walk(int i, int step, int na_, int nb_)
      : na(na_), nb(max(nb_, 1)) {
    a = i % na;
    b = i / na % nb;
    c = i / (na * nb);
    da = step % na;
    db = step / na % nb;
    dc = step / (na * nb);
  }
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    c += dc;
    if (a >= na) {
      a -= na;
      ++b;
    }
    if (b >= nb) {
      b -= nb;
      ++c;
    }
  }
};

// ldmatrix / stmatrix on a shared-space byte address (the inner loops
// keep their addresses in that form).
__device__ __forceinline__ void ldsm_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&a)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4_trans(unsigned addr,
                                              const unsigned (&v)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1,%2,%3,%4};\n" ::"r"(addr),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
      : "memory");
}

__device__ __forceinline__ void stsm_x2_trans(unsigned addr,
                                              const unsigned (&v)[2]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1,%2};\n" ::
          "r"(addr),
      "r"(v[0]), "r"(v[1])
      : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Shared-memory tap halo: [R + 2 rows][tw + 2 cols][stride], channel-minor
// bf16, x channels then h channels. stride / 8 is odd so the 8 rows of an
// ldmatrix hit 8 different 16-byte bank groups.
__host__ __device__ inline int mma_stride(int cn) {
  const int units = cn / 8;
  return 8 * (units % 2 ? units : units + 1);
}

// Table of k8 groups (packed columns 8g .. 8g+7) -> halo offset of pixel 0
// for a halo of x channels (xg groups of 8) then h channels (hg groups).
// With wofs, also the group's first weight column in an OHWI weight row:
// tap * (Cx + C) + chs.
__device__ __forceinline__ void fill_group_offsets(int* goff, int xg, int hg,
                                                   int Cx, int twp,
                                                   int stride,
                                                   int* wofs = nullptr) {
  const int n_groups = 9 * (xg + hg);
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
    if (wofs) wofs[g] = tap * (8 * (xg + hg)) + chs;
  }
}

// One block: image b, output rows y0 .. y0 + R - 1, columns [x0, x0 + tw),
// tw = 16 * wm; the R + 2 halo rows are staged once for the R rows.
// Warp w: m-tile w % wm, channel blocks (w / wm) * J .. + J - 1.
// NchwLayout's weight groups are found by the wofs table (OHWI columns)
// instead of 8 * g (packed columns); a B pair is one 32-bit load in both.
template <int J, typename Layout, typename Epi>
__global__ void __launch_bounds__(kThreads)
cell_mma_kernel(const __nv_bfloat16* __restrict__ h_prev,
                const __nv_bfloat16* __restrict__ x_pad,
                const __nv_bfloat16* __restrict__ wt, int H, int W, int C,
                int Cx, int wm, int R, int n_tiles, Epi epi) {
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
  int* goff = reinterpret_cast<int*>(halo + (R + 2) * twp * stride);
  int* wofs = goff + n_groups;  // NchwLayout only
  if constexpr (Layout::kPackedWeight)
    fill_group_offsets(goff, xg, hg, Cx, twp, stride);
  else
    fill_group_offsets(goff, xg, hg, Cx, twp, stride, wofs);
  stage_halo<Layout>(h_prev, x_pad, b, y0, x0, H, W, C, Cx, twp, R + 2,
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
  // 8*g + 2*(lane%4) (packed) or wofs[g] + 2*(lane%4) (OHWI)
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
        if constexpr (Layout::kPackedWeight) {
          dst[j][q][0] = *reinterpret_cast<const unsigned*>(wp + 8 * g0);
          dst[j][q][1] =
              has_g1 ? *reinterpret_cast<const unsigned*>(wp + 8 * (g0 + 1))
                     : 0u;
        } else {
          dst[j][q][0] = *reinterpret_cast<const unsigned*>(wp + wofs[g0]);
          dst[j][q][1] =
              has_g1 ? *reinterpret_cast<const unsigned*>(wp + wofs[g0 + 1])
                     : 0u;
        }
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
        epi(row, c, x, acc[j][0][e], acc[j][1][e], acc[j][2][e],
            acc[j][3][e]);
      }
  }
}

// Launches the tensor-core kernel when the shapes allow it; returns
// cudaErrorNotSupported when they do not (the caller then takes the FMA
// kernel).
template <int J, typename Layout, typename Epi>
cudaError_t launch_cell_mma(const void* h_prev, const void* x_pad,
                            const void* wt, int B, int H, int W, int C,
                            int Cx, cudaStream_t stream, Epi epi) {
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
           (size_t)9 * (Cx + C) / 8 * sizeof(int) *
               (Layout::kPackedWeight ? 1 : 2);
    if (smem <= kMaxSmem || R == 1) break;
    R /= 2;
  }
  if (smem > kMaxSmem) return cudaErrorNotSupported;
  auto kern = cell_mma_kernel<J, Layout, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((H + R - 1) / R) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  kern<<<(unsigned)blocks, 32 * wm * wn, smem, stream>>>(
      static_cast<const bf*>(h_prev), static_cast<const bf*>(x_pad),
      static_cast<const bf*>(wt), H, W, C, Cx, wm, R, n_tiles, epi);
  return cudaGetLastError();
}

template <typename T, int G, int P, typename Layout, typename Epi>
cudaError_t launch_cell_fma(const void* h_prev, const void* x_pad,
                            const void* wt, int B, int H, int W, int C,
                            int Cx, cudaStream_t stream, Epi epi) {
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
    if (smem <= kMaxSmem || pgs == 1) break;
    pgs /= 2;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int tw = pgs * P;
  const int n_tiles = (W + tw - 1) / tw;
  auto kern = cell_fma_kernel<T, G, P, Layout, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, pgs * cgs, smem, stream>>>(
      static_cast<const T*>(h_prev), static_cast<const T*>(x_pad),
      static_cast<const T*>(wt), H, W, C, Cx, tw, n_tiles, epi);
  return cudaGetLastError();
}

// The gate convolution with epilogue epi: the tensor cores for bf16 with
// C and Cx multiples of 8, the FMA loop otherwise. x_pad is the x operand
// of the layout (padded for RowMajorLayout, unpadded for NchwLayout).
template <typename T, typename Layout = RowMajorLayout, typename Epi>
cudaError_t launch_cell(const void* h_prev, const void* x_pad, const void* wt,
                        int B, int H, int W, int C, int Cx,
                        cudaStream_t stream, Epi epi) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cx < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorNotSupported;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (C % 8 == 0 && Cx % 8 == 0)
      err = (C / 8) % 2 == 0
                ? launch_cell_mma<2, Layout>(h_prev, x_pad, wt, B, H, W, C,
                                             Cx, stream, epi)
                : launch_cell_mma<1, Layout>(h_prev, x_pad, wt, B, H, W, C,
                                             Cx, stream, epi);
  }
  if (err != cudaErrorNotSupported) return err;
  if (C % 2 == 0)
    return launch_cell_fma<T, 2, 4, Layout>(h_prev, x_pad, wt, B, H, W, C,
                                            Cx, stream, epi);
  return launch_cell_fma<T, 1, 8, Layout>(h_prev, x_pad, wt, B, H, W, C, Cx,
                                          stream, epi);
}

}  // namespace rsis
