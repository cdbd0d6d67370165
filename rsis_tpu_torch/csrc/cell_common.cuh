// Shared machinery of the ConvLSTM cell kernels (fused_cell.cu, the
// forward, cell_bwd.cu, the backward, and clstm_step.cu, the NCHW step):
// the halo staging, the mma.sync helpers and the gate convolution's main
// loops, each with the epilogue as a template argument; and the
// asynchronous staging helpers (cp.async, ldmatrix / stmatrix on shared
// addresses, the Walk counters) of weight_grad.cu and conv3x3.cu.
//
// The gate convolution, for tensors stored (B, H, C, W):
//   gates = conv3x3_same([x_pad (Cx) || h_prev (C)], W)          (4C, fp32)
// x_pad (B, H+2, Cx, W+2) carries its zero halo already; h_prev is
// unpadded and its SAME halo is zero (not a clamp). wt is the packed
// (4C, 9(Cx+C)) weight of pack_cell_weights: the 9 x taps first
// (tap-major, channel-minor), then the 9 h taps. Cx == 0 (cell 0) means
// there is no x input. The epilogue receives, for each (row = b * H + y,
// channel c, column x), the four gate sums i, f, o, g (without S) and does
// whatever the kernel is for: the LSTM update (forward; K8's with its fp32
// bias) or the gate cotangents (backward). The kernels therefore compute
// the same gate sums in the same order.
//
// Two main loops:
//   - the staged loop (cell_staged_kernel; K1, K4 and K8 in bf16 with C,
//     Cx and W multiples of 8, every cell at hidden 128; K1 also at any W,
//     the edge variant below): a block owns a
//     unit of rows x tw pixels and a tile of Ct hidden channels with all
//     four of their gates; the weight streams once per unit through shared
//     memory in K-chunks of nine taps x cc channels of x or of h, beside
//     the chunk's halo (16-byte cp.async copies into a ring, transposed
//     once to [pixel][channel]); mma.sync m16n8k16 with fp32
//     accumulators; the epilogue's operands are staged as W-contiguous
//     rows and read in fragment order by ldmatrix.trans, and its outputs
//     leave through shared memory in 16-byte stores. The plan comes from
//     the host (cell_plan in ops/fused_cell.py);
//   - otherwise (fp32, other widths): fp32 FMA on CUDA cores, each thread
//     owning G channels x 4 gates x P pixels.
// Both keep the products exact in fp32 for bf16 inputs, as the plain
// versions do.
//
// Two operand layouts (the Layout template argument of both loops):
// RowMajorLayout is the one above (the decode's kernels K1 and K4);
// NchwLayout reads an unpadded NCHW x (B, Cx, H, W) and h_prev (B, C, H,
// W) with a zero SAME halo, for the ConvLSTM step of clstm_step.cu (K8).
// The staged loop takes the packed weight in both; the FMA loop takes
// NchwLayout's weight as OHWI (4C, 3, 3, Cx+C) (column tap * (Cx+C) + ch
// of a weight row). Both give the main loops the same concat-channel
// order (x channels, then h) and the same products in the same order.

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

// ---- tensor-core helpers ----------------------------------------------
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and ldmatrix on generic
// shared-memory pointers.

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

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&a)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&a)[2],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
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

// An mbarrier in shared memory: init for `count` arrivals a phase; an
// arrival of this thread once its cp.async copies so far have landed; a
// wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_init(unsigned addr, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(addr),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void cp_async_mbar_arrive(unsigned addr) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   addr)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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

// The FMA loop with its thread tile chosen by C.
template <typename T, typename Layout, typename Epi>
cudaError_t launch_cell_fma_loop(const void* h_prev, const void* x_pad,
                                 const void* wt, int B, int H, int W, int C,
                                 int Cx, cudaStream_t stream, Epi epi) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cx < 0)
    return cudaErrorInvalidValue;
  if (C % 2 == 0)
    return launch_cell_fma<T, 2, 4, Layout>(h_prev, x_pad, wt, B, H, W, C,
                                            Cx, stream, epi);
  return launch_cell_fma<T, 1, 8, Layout>(h_prev, x_pad, wt, B, H, W, C, Cx,
                                          stream, epi);
}

// ---- the staged loop (K1, K4, K8) ---------------------------------------
//
// The host's plan (cell_plan in ops/fused_cell.py): warps_m x warps_n
// warps of WM m-tiles (16 pixels of one row) x J blocks of 8 hidden
// channels, i.e. 4 J n-tiles, the gates i, f, o, g of each block, so a
// lane holds all four gates of its (pixel, channel) pairs; units of
// rows x tw output pixels (rows * tw = 16 WM warps_m) and a tile of Ct =
// 8 J warps_n hidden channels (weight rows q C + c0 .. + Ct - 1 for each
// gate q); K-chunks of all nine taps x cc channels, the x channels' chunks
// first (pack_cell_weights' order), in a ring of `stages`; the chunks cut
// into `splits` parts and the units dealt in order to `groups` blocks per
// (channel tile, part). The Layout says where a chunk's rows come from:
// RowMajorLayout's x_pad rows from their 16-byte boundary and h_prev's
// (B, H, C, W) rows, or NchwLayout's x and h_prev rows (B, Cin, H, W),
// both like h_prev's, with a zero SAME halo.
//
// The edge variant (kEdge; K1 where W is not a multiple of 8, as the
// CVPPP recipe's 13-, 25-, 50- and 100-wide cells are): rows then start
// at any 2-byte boundary and end inside a 16-byte group. Every row the
// block stages, x_pad's and h_prev's as the epilogue's planes, is copied
// from the 16-byte boundary at or before its first element, with the
// tensor's end bounding the last copy, and read at its phase (the first
// element's place in that group) by 16-bit loads: the transposition takes
// h's columns outside 0 .. W - 1 as zero (the SAME halo; the copies hold
// the neighbouring rows' values there), and the epilogue reads its planes
// element by element, writes each output over its own input element and
// stores the outputs' rows element by element. The aligned kernels are
// untouched by it.
struct CellPlan {
  int warps_m, warps_n, rows, tw, cc, stages, splits, groups;
};

// Shared-memory layout of one block, in bf16 elements: the ring's raw
// input rows, the weight slots (one when a block has one chunk: it
// stays), the transposed halo, the epilogue's planes (none with parts;
// in the edge variant each of the unit's rows takes tw + 8 elements, its
// copies from the 16-byte boundary),
// 8 elements of trash for stmatrix rows past the halo, the mbarrier of
// the planes' copies and, for an epilogue with a bias, its `bias` fp32
// values. Every region
// starts 16-byte aligned; each row stride is an odd number of 16-byte
// groups, so the 8 rows of an ldmatrix or stmatrix hit 8 bank groups.
struct CellSmem {
  int rs, ks, cs, twp, os, raw, wgt, wslots, halo, epi, stages, bias;
  __host__ __device__ CellSmem(const CellPlan& p, int ct, int cps,
                               int planes, int bias_floats = 0,
                               bool edge = false) {
    rs = p.tw + 24;   // raw row: h pixels x0 - 8 .. x0 + tw + 15
    ks = 9 * p.cc + ((9 * p.cc / 8) % 2 ? 16 : 8);   // weight row
    cs = p.cc + ((p.cc / 8) % 2 ? 0 : 8);            // halo row
    twp = p.tw + 2;   // halo rows per staged input row: padded columns
    // epilogue row: the unit's pixels (edge: rows of tw + 8)
    os = p.rows * (edge ? p.tw + 8 : p.tw) + 8;
    raw = (p.rows + 2) * p.cc * rs;
    wgt = 4 * ct * ks;
    wslots = cps == 1 ? 1 : p.stages;
    halo = (p.rows + 2) * twp * cs;
    epi = p.splits > 1 ? 0 : planes * ct * os;
    stages = p.stages;
    bias = bias_floats;
  }
  // then 16 bytes for the epilogue's mbarrier and the bias
  __host__ __device__ size_t bytes() const {
    return (size_t)(stages * raw + wslots * wgt + halo + epi + 8) *
               sizeof(__nv_bfloat16) +
           16 + (size_t)bias * sizeof(float);
  }
};

// The epilogue Epi (LstmForward in fused_cell.cu, LstmBackward in
// cell_bwd.cu, LstmStep in clstm_step.cu) names kIn planes of
// W-contiguous rows (in_row, for row = b * H + y), staged per unit as
// [plane][channel][pixel], and kOut outputs (out_row), each written into
// plane out_plane(k) before it leaves, so a block holds max(kIn, kOut)
// planes; tile() maps the four gate sums and the kIn plane values of one
// (pixel, channel) to the kOut outputs, and operator() is the same map on
// device memory for one (row, c, x) (the parts' sum). An Epi with kBias
// (LstmStep) has an fp32 bias of 4C values, gate-major: a block keeps its
// tile's 4 Ct in shared memory and adds them to the gate sums before
// tile(); operator() adds them itself.
//
// kBlocks: the blocks an SM holds at once, the plan's per_sm: two (a
// thread within 128 registers) only with at most 64 accumulators a thread
// and where two blocks' shared memory fits.
//
// kNarrow: cc = 8, half of mma's k16: a k16 step pairs two taps of the
// chunk (5 steps for 9 taps, the last half empty: 11% more products than
// the chunk needs, at cells whose bytes bound them).
template <typename Epi>
__host__ __device__ constexpr int epi_planes() {
  return Epi::kIn > Epi::kOut ? Epi::kIn : Epi::kOut;
}

template <typename Epi, typename = void>
struct EpiBias : std::false_type {};
template <typename Epi>
struct EpiBias<Epi, std::void_t<decltype(Epi::kBias)>>
    : std::integral_constant<bool, Epi::kBias> {};

template <int WM, int J, bool kNarrow, int kBlocks, bool kEdge,
          typename Layout, typename Epi>
__global__ void __launch_bounds__(kThreads, kBlocks)
cell_staged_kernel(const __nv_bfloat16* __restrict__ h_prev,
                   const __nv_bfloat16* __restrict__ x_pad,
                   const __nv_bfloat16* __restrict__ wt,
                   float* __restrict__ ws, int B, int H, int W, int C, int Cx,
                   CellPlan p, Epi epi) {
  using bf16 = __nv_bfloat16;
  constexpr bool kNchw = std::is_same<Layout, NchwLayout>::value;
  constexpr bool kBias = EpiBias<Epi>::value;
  static_assert(!kEdge || !kNchw, "the edge variant reads (B, H, C, W)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ct = 8 * J * p.warps_n;
  const int cc = p.cc;
  const int nxc = Cx / cc;                      // x chunks, then h chunks
  const int cps = (Cx + C) / cc / p.splits;     // chunks a block walks a unit
  const CellSmem L(p, ct, cps, epi_planes<Epi>(), kBias ? 4 * ct : 0,
                   kEdge);
  bf16* raw0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* wgt0 = raw0 + L.stages * L.raw;
  bf16* halo = wgt0 + L.wslots * L.wgt;
  bf16* etile = halo + L.halo;
  bf16* trash = etile + L.epi;
  const unsigned mbar = smem_addr(trash + 8);
  if (threadIdx.x == 0) mbar_init(mbar, blockDim.x);
  __syncthreads();
  unsigned mbar_phase = 0;

  const int R = p.rows;
  const int tw = p.tw;
  const int K = 9 * (Cx + C);
  const int n_xt = (W + tw - 1) / tw;
  const int n_rg = (H + R - 1) / R;
  const long long n_units = (long long)B * n_rg * n_xt;
  // channel tiles fastest: the blocks of one unit run together and share
  // its halo in L2
  const int n_ct = C / ct;
  const int c0 = blockIdx.x % n_ct * ct;
  const int split = blockIdx.x / n_ct % p.splits;
  const int group = blockIdx.x / (n_ct * p.splits);
  const long long u_begin = n_units * group / p.groups;
  const int n_my = (int)(n_units * (group + 1) / p.groups - u_begin);
  const int k_begin = split * cps;
  const int n_st = n_my * cps;   // ring stages: (unit, chunk), chunk-minor
  // the tile's gate biases [4][Ct] after the mbarrier (read behind the
  // main loop's first barrier; the parts' sum adds them itself)
  float* bias_s = reinterpret_cast<float*>(trash + 16);
  if constexpr (kBias) {
    if (p.splits == 1)
      for (int i = threadIdx.x; i < 4 * ct; i += blockDim.x)
        bias_s[i] = epi.bias[i / ct * C + c0 + i % ct];
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int wmi = warp % p.warps_m;
  const int nw0 = warp / p.warps_m * 8 * J;   // the warp's first channel

  auto unit_origin = [&](long long u, int& b, int& y0, int& x0) {
    x0 = (int)(u % n_xt) * tw;
    y0 = (int)(u / n_xt % n_rg) * R;
    b = (int)(u / ((long long)n_xt * n_rg));
  };
  // x_pad's row (b, py, x channel ch) starts at element x_row(b, py, ch);
  // (W + 2)-element rows are 4-byte but not 16-byte aligned: a row is
  // staged from the 16-byte boundary at or before padded column x0, and
  // its phase (x_row + x0) % 8 (even) says where x0 landed
  const long long x_numel = (long long)B * (H + 2) * Cx * (W + 2);
  auto x_row = [&](int b, int py, int ch) {
    return ((long long)(b * (H + 2) + py) * Cx + ch) * (W + 2);
  };
  // the edge variant: the byte address of the first element a staged row
  // needs (x_pad's padded column x0, h's column x0 - 1: both the halo's
  // column 0)
  auto edge_first = [&](bool is_x, int b, int r, int y0, int x0, int ch) {
    return is_x ? (long long)(size_t)x_pad + 2 * (x_row(b, y0 + r, ch) + x0)
                : (long long)(size_t)h_prev +
                      2 * (((long long)(b * H + y0 + r - 1) * C + ch) * W +
                           x0 - 1);
  };

  // cp.async of stage k into ring slot k % stages: raw[(R + 2) rows][cc]
  // [rs] holds x_pad's rows from the 16-byte boundary (tw / 8 + 1 copies,
  // past the tensor's end zero) or h's columns x0 - 8 .. x0 + tw + 7 (tw /
  // 8 + 2 copies, zero outside the image; NchwLayout's x rows too); the
  // weight slot [4 Ct][ks] the chunk's columns of the block's weight rows,
  // gate-major, tap-major
  const int qx = kEdge ? tw / 8 + 2 : tw / 8 + 1;
  const int qh = tw / 8 + 2;
  const Walk w_x(threadIdx.x, blockDim.x, qx, cc);
  const Walk w_h(threadIdx.x, blockDim.x, qh, cc);
  const Walk w_wgt(threadIdx.x, blockDim.x, cc / 8, 9);
  auto fetch = [&](int k) {
    const int slot = k % L.stages;
    int b, y0, x0;
    unit_origin(u_begin + k / cps, b, y0, x0);
    const int chunk = k_begin + k % cps;
    const bool is_x = chunk < nxc;
    const int ch0 = (is_x ? chunk : chunk - nxc) * cc;
    bf16* raw = raw0 + slot * L.raw;
    if constexpr (kEdge) {
      // tw / 8 + 2 copies from the 16-byte boundary at or before the
      // row's first element, none outside the tensor, the last one cut at
      // its end
      const long long lo = (long long)(size_t)(is_x ? x_pad : h_prev);
      const long long end = (long long)(size_t)(
          is_x ? x_pad + x_numel : h_prev + (size_t)B * H * C * W);
      Walk w = w_x;
      for (int i = threadIdx.x; i < (R + 2) * cc * qx;
           i += blockDim.x, w.next()) {
        const int py = y0 + w.c;
        const bool row_ok = is_x ? py < H + 2 : py >= 1 && py <= H;
        const long long g =
            (edge_first(is_x, b, w.c, y0, x0, ch0 + w.b) & ~15LL) + 16 * w.a;
        const bool ok = row_ok && g >= lo && g < end;
        cp_async16(raw + (w.c * cc + w.b) * L.rs + 8 * w.a,
                   ok ? reinterpret_cast<const void*>(g) : wt,
                   ok ? (int)min(16LL, end - g) : 0);
      }
    } else if constexpr (kNchw) {
      // x (B, Cx, H, W) or h_prev (B, C, H, W)
      const bf16* src = is_x ? x_pad : h_prev;
      const int cin = is_x ? Cx : C;
      Walk w = w_h;
      for (int i = threadIdx.x; i < (R + 2) * cc * qh;
           i += blockDim.x, w.next()) {
        const int iy = y0 + w.c - 1;
        const int ix = x0 - 8 + 8 * w.a;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async16(raw + (w.c * cc + w.b) * L.rs + 8 * w.a,
                   ok ? src + ((size_t)(b * cin + ch0 + w.b) * H + iy) * W +
                            ix
                      : wt,
                   ok ? 16 : 0);
      }
    } else if (is_x) {
      Walk w = w_x;
      for (int i = threadIdx.x; i < (R + 2) * cc * qx;
           i += blockDim.x, w.next()) {
        const long long e =
            ((x_row(b, y0 + w.c, ch0 + w.b) + x0) & ~7LL) + 8 * w.a;
        const bool ok = y0 + w.c < H + 2 && e < x_numel;
        cp_async16(raw + (w.c * cc + w.b) * L.rs + 8 * w.a,
                   ok ? x_pad + e : wt,
                   ok ? (int)min(16LL, 2 * (x_numel - e)) : 0);
      }
    } else {
      Walk w = w_h;
      for (int i = threadIdx.x; i < (R + 2) * cc * qh;
           i += blockDim.x, w.next()) {
        const int iy = y0 + w.c - 1;
        const int ix = x0 - 8 + 8 * w.a;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async16(raw + (w.c * cc + w.b) * L.rs + 8 * w.a,
                   ok ? h_prev + ((size_t)(b * H + iy) * C + ch0 + w.b) * W +
                            ix
                      : wt,
                   ok ? 16 : 0);
      }
    }
    if (cps == 1 && k > 0) return;   // the block's one chunk stays
    bf16* wg = wgt0 + (cps == 1 ? 0 : slot) * L.wgt;
    const int col0 = is_x ? ch0 : 9 * Cx + ch0;
    const int tap_cols = is_x ? Cx : C;
    Walk w = w_wgt;
    for (int i = threadIdx.x; i < 4 * ct * 9 * (cc / 8);
         i += blockDim.x, w.next()) {
      const int q = w.c / ct;
      cp_async16(wg + w.c * L.ks + w.b * cc + 8 * w.a,
                 wt + (size_t)(q * C + c0 + w.c - q * ct) * K + col0 +
                     w.b * tap_cols + 8 * w.a,
                 16);
    }
  };

  // the epilogue's planes of unit u: [kIn planes][Ct][os], each row the
  // unit's pixels (R rows of tw); zero past the image
  const Walk w_e(threadIdx.x, blockDim.x, tw / 8, R);
  // the edge variant: row r of a plane's channel at [r (tw + 8)], its
  // tw / 8 + 1 copies from the 16-byte boundary at or before column x0,
  // the element of column x0 at the row's phase (edge_phase)
  const int er = tw + 8;
  auto plane_end = [&](int pl) {
    return (long long)(size_t)(epi.in_row(pl, (size_t)B * H - 1, C - 1) + W);
  };
  auto edge_phase = [&](int pl, size_t row, int c, int x0) {
    return (int)(((size_t)(epi.in_row(pl, row, c) + x0) >> 1) & 7);
  };
  auto fetch_epi = [&](long long u) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    if constexpr (kEdge) {
      Walk w(threadIdx.x, blockDim.x, tw / 8 + 1, R);
      for (int i = threadIdx.x; i < Epi::kIn * ct * R * (tw / 8 + 1);
           i += blockDim.x, w.next()) {
        const int y = y0 + w.b;
        const int pl = w.c / ct;
        long long g = 0, end = 0;
        if (y < H) {
          g = ((long long)(size_t)(epi.in_row(pl, (size_t)b * H + y,
                                              c0 + w.c - pl * ct) +
                                   x0) &
               ~15LL) +
              16 * w.a;
          end = plane_end(pl);
        }
        const bool ok = g < end;
        cp_async16(etile + w.c * L.os + w.b * er + 8 * w.a,
                   ok ? reinterpret_cast<const void*>(g) : wt,
                   ok ? (int)min(16LL, end - g) : 0);
      }
      return;
    }
    Walk w = w_e;
    for (int i = threadIdx.x; i < Epi::kIn * ct * R * (tw / 8);
         i += blockDim.x, w.next()) {
      const int y = y0 + w.b;
      const int xx = x0 + 8 * w.a;
      const bool ok = y < H && xx < W;
      const int pl = w.c / ct;
      cp_async16(etile + w.c * L.os + w.b * tw + 8 * w.a,
                 ok ? epi.in_row(pl, (size_t)b * H + y, c0 + w.c - pl * ct) +
                          xx
                    : wt,
                 ok ? 16 : 0);
    }
  };

  // raw (stage k) -> halo[(R + 2) rows][tw + 2 padded columns][cs] in 8x8
  // blocks (8 channels x 8 padded columns), four neighbouring column
  // blocks a warp instruction: x_pad rows by 32-bit loads at their phase,
  // h rows (and NchwLayout's x rows) by ldmatrix (raw column j is padded
  // column j - 7), either way the fragment ldmatrix would give, then
  // stmatrix.trans; rows of a block outside the padded columns go to the
  // trash
  const int nq4 = (tw / 8 + 5) / 4;
  const int nquad = (R + 2) * (cc / 8) * nq4;
  const Walk w_t(warp, nw, nq4, cc / 8);
  auto transpose = [&](int k) {
    int b, y0, x0;
    unit_origin(u_begin + k / cps, b, y0, x0);
    const int chunk = k_begin + k % cps;
    const bool is_x = chunk < nxc;
    const int ch0 = (is_x ? chunk : chunk - nxc) * cc;
    const bf16* raw = raw0 + (k % L.stages) * L.raw;
    Walk w = w_t;
    for (int qd = warp; qd < nquad; qd += nw, w.next()) {
      const int r = w.c;
      const int g = w.b;
      const int q = 4 * w.a + (lane >> 3);   // this lane's store block
      unsigned v[4];
      if constexpr (kEdge) {
        // raw column phase + j is the halo's column j; h's columns
        // outside 0 .. W - 1 (x0 - 1 + j) read zero
        const int c = 8 * g + (lane >> 2);
        const int phase =
            (int)((edge_first(is_x, b, r, y0, x0, ch0 + c) >> 1) & 7);
        const unsigned short* row = reinterpret_cast<const unsigned short*>(
            raw + (r * cc + c) * L.rs + phase + 2 * (lane & 3));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = 8 * (4 * w.a + m) + 2 * (lane & 3);
          unsigned lo = row[8 * (4 * w.a + m)];
          unsigned hi = row[8 * (4 * w.a + m) + 1];
          if (!is_x) {
            const int hx = x0 - 1 + j;
            if (hx < 0 || hx >= W) lo = 0u;
            if (hx + 1 < 0 || hx + 1 >= W) hi = 0u;
          }
          v[m] = lo | (hi << 16);
        }
      } else if (kNchw || !is_x) {
        ldmatrix_x4(v, raw + (r * cc + 8 * g + (lane & 7)) * L.rs + 8 * q);
      } else {
        const int c = 8 * g + (lane >> 2);
        const int phase = (int)((x_row(b, y0 + r, ch0 + c) + x0) & 7);
        const bf16* row = raw + (r * cc + c) * L.rs + phase + 2 * (lane & 3);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          v[m] = *reinterpret_cast<const unsigned*>(row + 8 * (4 * w.a + m));
      }
      const int pc =
          8 * q + (lane & 7) - (kEdge || (is_x && !kNchw) ? 0 : 7);
      stmatrix_x4_trans(pc >= 0 && pc < L.twp
                            ? halo + (r * L.twp + pc) * L.cs + 8 * g
                            : trash,
                        v);
    }
  };


  float acc[WM][J][4][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][q][e] = 0.0f;
  };
  zero_acc();

  // the warp's m-tiles: unit pixel u_m[i] = r * tw + px (16 pixels of one
  // output row r); A rows by ldmatrix from halo row r + dy, column px + dx
  const unsigned halo_s = smem_addr(halo);
  int u_m[WM];
  unsigned a_base[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int mt = wmi * WM + i;
    const int r = mt / (tw / 16);
    const int px = mt % (tw / 16) * 16;
    u_m[i] = r * tw + px;
    a_base[i] = halo_s + ((r * L.twp + px + (lane & 15)) * L.cs +
                          (kNarrow ? 0 : (lane >> 4) * 8)) * 2;
  }
  // B rows by ldmatrix x4: matrices (gate q, k 0-7), (q, k 8-15), (q + 1,
  // k 0-7), (q + 1, k 8-15) of a channel block
  const unsigned b_lane =
      ((nw0 + (lane & 7) + (lane >> 4) * ct) * L.ks + ((lane >> 3) & 1) * 8) *
      2;
  // one k16 step: A from halo offset a_off (lanes 16-31: a_off_hi), B from
  // weight column col; hi_zero drops the upper half of k (both operands)
  auto step = [&](unsigned wb, unsigned a_off, unsigned a_off_hi, int col,
                  bool hi_zero) {
    unsigned a[WM][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      ldsm_x4(a[i], a_base[i] + ((lane >> 4) ? a_off_hi : a_off));
      if (hi_zero) a[i][2] = a[i][3] = 0u;
    }
    unsigned bf[J][4][2];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        unsigned t4[4];
        ldsm_x4(t4, wb + ((j * 8 + q * ct) * L.ks + col) * 2);
        bf[j][q][0] = t4[0];
        bf[j][q][1] = hi_zero ? 0u : t4[1];
        bf[j][q + 1][0] = t4[2];
        bf[j][q + 1][1] = hi_zero ? 0u : t4[3];
      }
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_bf16(acc[i][j][q], a[i], bf[j][q][0], bf[j][q][1]);
  };
  auto tap_off = [&](int tap) {
    return (unsigned)(((tap / 3) * L.twp + tap % 3) * L.cs * 2);
  };
  auto compute = [&](int slot) {
    const unsigned wb = smem_addr(wgt0 + (cps == 1 ? 0 : slot) * L.wgt) +
                        b_lane;
    if constexpr (kNarrow) {
      // 8-channel chunks: a k16 step takes taps 2s and 2s + 1 (A's lanes
      // 16-31 address tap 2s + 1's rows; the weight columns 16s .. 16s +
      // 15 are those taps' channels); tap 8 alone, its upper half zero
#pragma unroll
      for (int s2 = 0; s2 < 5; ++s2) {
        const int t0 = 2 * s2;
        step(wb, tap_off(t0), tap_off(t0 < 8 ? t0 + 1 : t0), 16 * s2,
             t0 == 8);
      }
    } else {
      for (int kk = 0; kk < cc; kk += 16) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const unsigned a_off = tap_off(tap) + kk * 2;
          step(wb, a_off, a_off, tap * cc + kk, false);
        }
      }
    }
  };

  // D fragment: pixels lane / 4 (+ 8), channels 2 (lane % 4) (+ 1)
  auto pack = [](float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  };
  auto unpack = [](unsigned v, float& lo, float& hi) {
    const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&v);
    lo = __low2float(h2);
    hi = __high2float(h2);
  };
  auto epilogue = [&](long long u) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    if (p.splits > 1) {
      // fp32 partial gate sums of this part, (B, H, 4C, W), straight from
      // the fragments (a quad's 8 pixels are one 32-byte sector)
      float* part = ws + (size_t)split * ((size_t)B * H * 4 * C * W);
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int y = y0 + u_m[i] / tw;
        if (y >= H) continue;
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int xx = x0 + u_m[i] % tw + (lane >> 2) + (e >> 1) * 8;
              const int c = c0 + nw0 + 8 * j + 2 * (lane & 3) + (e & 1);
              if (xx < W)
                part[((size_t)(b * H + y) * 4 * C + q * C + c) * W + xx] =
                    acc[i][j][q][e];
            }
      }
      zero_acc();
      return;
    }
    mbar_wait(mbar, mbar_phase);   // this unit's planes have landed
    mbar_phase ^= 1u;
    if constexpr (kEdge) {
      // each lane reads its (pixel, channel) elements of the planes at
      // their rows' phases and writes each output over its own element of
      // plane out_plane(k); then the rows leave element by element
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int r = u_m[i] / tw;
        const int px = u_m[i] % tw + (lane >> 2);
        const size_t row = (size_t)b * H + min(y0 + r, H - 1);
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int s1 = 0; s1 < 2; ++s1) {
            const int cl = nw0 + 8 * j + 2 * (lane & 3) + s1;
            unsigned short* pv[Epi::kIn];
#pragma unroll
            for (int pl = 0; pl < Epi::kIn; ++pl)
              pv[pl] = reinterpret_cast<unsigned short*>(
                           etile + (pl * ct + cl) * L.os + r * er +
                           edge_phase(pl, row, c0 + cl, x0)) +
                       px;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float g[4] = {acc[i][j][0][2 * hf + s1],
                            acc[i][j][1][2 * hf + s1],
                            acc[i][j][2][2 * hf + s1],
                            acc[i][j][3][2 * hf + s1]};
              if constexpr (kBias) {
#pragma unroll
                for (int q = 0; q < 4; ++q) g[q] += bias_s[q * ct + cl];
              }
              float ve[Epi::kIn], o[Epi::kOut];
#pragma unroll
              for (int pl = 0; pl < Epi::kIn; ++pl)
                ve[pl] = __uint_as_float((unsigned)pv[pl][8 * hf] << 16);
              epi.tile(g, ve, o);
#pragma unroll
              for (int k = 0; k < Epi::kOut; ++k)
                pv[Epi::out_plane(k)][8 * hf] =
                    __bfloat16_as_ushort(__float2bfloat16_rn(o[k]));
            }
          }
      }
      zero_acc();
      __syncthreads();
      Walk w(threadIdx.x, blockDim.x, tw, R);
      for (int i = threadIdx.x; i < Epi::kOut * ct * R * tw;
           i += blockDim.x, w.next()) {
        const int y = y0 + w.b;
        const int xx = x0 + w.a;
        if (y >= H || xx >= W) continue;
        const int k = w.c / ct;
        const int cl = w.c - k * ct;
        const int pl = Epi::out_plane(k);
        const size_t row = (size_t)b * H + y;
        epi.out_row(k, row, c0 + cl)[xx] =
            etile[(pl * ct + cl) * L.os + w.b * er +
                  edge_phase(pl, row, c0 + cl, x0) + w.a];
      }
      return;
    }
    // fragments of the planes by ldmatrix.trans of 8 channels x 8 pixels:
    // x4 matrices (plane pl, pixels 0-7), (pl, 8-15), (pl + 1, 0-7), (pl
    // + 1, 8-15); the outputs go back by stmatrix.trans to the same places
    // of their planes
    const unsigned plane = ct * L.os * 2;
    const unsigned e_lane = smem_addr(etile) +
                            ((nw0 + (lane & 7)) * L.os +
                             ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const unsigned at = e_lane + (j * 8 * L.os + u_m[i]) * 2;
        // plane pl's pairs: vp[pl][0] pixel lane / 4 (e = 0, 1), vp[pl][1]
        // pixel lane / 4 + 8 (e = 2, 3), unpacked one e at a time
        unsigned vp[Epi::kIn][2];
#pragma unroll
        for (int pl = 0; pl < Epi::kIn; pl += 2) {
          if (pl + 1 < Epi::kIn) {
            unsigned t[4];
            ldsm_x4_trans(t, at + (pl + (lane >> 4)) * plane);
            vp[pl][0] = t[0];
            vp[pl][1] = t[1];
            vp[pl + 1][0] = t[2];
            vp[pl + 1][1] = t[3];
          } else {
            ldsm_x2_trans(vp[pl], at + pl * plane);
          }
        }
        unsigned op[Epi::kOut][2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float lo[Epi::kOut], hi[Epi::kOut];
#pragma unroll
          for (int s1 = 0; s1 < 2; ++s1) {
            const int e = 2 * hf + s1;
            float g[4] = {acc[i][j][0][e], acc[i][j][1][e], acc[i][j][2][e],
                          acc[i][j][3][e]};
            if constexpr (kBias) {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                g[q] += bias_s[q * ct + nw0 + 8 * j + 2 * (lane & 3) + s1];
            }
            float ve[Epi::kIn];
#pragma unroll
            for (int pl = 0; pl < Epi::kIn; ++pl) {
              float x_lo, x_hi;
              unpack(vp[pl][hf], x_lo, x_hi);
              ve[pl] = s1 ? x_hi : x_lo;
            }
            if (s1)
              epi.tile(g, ve, hi);
            else
              epi.tile(g, ve, lo);
          }
#pragma unroll
          for (int k = 0; k < Epi::kOut; ++k) op[k][hf] = pack(lo[k], hi[k]);
        }
#pragma unroll
        for (int k = 0; k < Epi::kOut; k += 2) {
          if (k + 1 < Epi::kOut) {
            const unsigned t[4] = {op[k][0], op[k][1], op[k + 1][0],
                                   op[k + 1][1]};
            stsm_x4_trans(at + Epi::out_plane(k + (lane >> 4)) * plane, t);
          } else {
            stsm_x2_trans(at + Epi::out_plane(k) * plane, op[k]);
          }
        }
      }
    zero_acc();
    __syncthreads();
    // the outputs' rows: 16-byte stores of 8 pixels, neighbouring threads
    // on neighbouring pieces of a row
    Walk w = w_e;
    for (int i = threadIdx.x; i < Epi::kOut * ct * R * (tw / 8);
         i += blockDim.x, w.next()) {
      const int y = y0 + w.b;
      const int xx = x0 + 8 * w.a;
      if (y >= H || xx >= W) continue;
      const int k = w.c / ct;
      const int cl = w.c - k * ct;
      *reinterpret_cast<uint4*>(epi.out_row(k, (size_t)b * H + y, c0 + cl) +
                                xx) =
          *reinterpret_cast<const uint4*>(
              etile + (Epi::out_plane(k) * ct + cl) * L.os + w.b * tw +
              8 * w.a);
    }
  };

  // the ring: stage k waits for its copies, the slot freed by stage k - 1
  // takes stage k + stages - 1, then stage k is transposed and multiplied;
  // a unit's first chunk also issues the copies of the unit's epilogue
  // planes (the previous unit's epilogue is done with them), tracked by
  // the mbarrier, so they land while the unit's chunks are multiplied; a
  // unit's last chunk ends in its epilogue
  for (int s = 0; s < L.stages - 1; ++s) {
    if (s < n_st) fetch(s);
    cp_async_commit();
  }
  for (int k = 0; k < n_st; ++k) {
    if (L.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (p.splits == 1 && k % cps == 0) {
      fetch_epi(u_begin + k / cps);
      cp_async_mbar_arrive(mbar);
    }
    const int next = k + L.stages - 1;
    if (next < n_st) fetch(next);
    cp_async_commit();
    transpose(k);
    __syncthreads();
    compute(k % L.stages);
    if (k % cps == cps - 1) epilogue(u_begin + k / cps);
  }
  cp_async_wait<0>();
}

// The parts' sum, in part order, through the element epilogue: one thread
// a (row, c, x) of the (B, H, C, W) state.
template <typename Epi>
__global__ void cell_reduce_kernel(const float* __restrict__ ws, Epi epi,
                                   int C, int W, int splits, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int c = (int)(i / W % C);
  const size_t row = (size_t)(i / ((long long)W * C));
  float g[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t at = (row * 4 * C + q * C + c) * W + x;
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += ws[(size_t)k * 4 * n + at];
    g[q] = s;
  }
  epi(row, c, x, g[0], g[1], g[2], g[3]);
}

template <int WM, int J, bool kNarrow, int kBlocks, bool kEdge,
          typename Layout, typename Epi>
cudaError_t launch_staged(const void* h_prev, const void* x_pad,
                          const void* wt, float* ws, int B, int H, int W,
                          int C, int Cx, const CellPlan& p,
                          cudaStream_t stream, Epi epi) {
  const int ct = 8 * J * p.warps_n;
  const size_t smem =
      CellSmem(p, ct, (Cx + C) / p.cc / p.splits, epi_planes<Epi>(),
               EpiBias<Epi>::value ? 4 * ct : 0, kEdge)
          .bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = cell_staged_kernel<WM, J, kNarrow, kBlocks, kEdge, Layout, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)(C / ct) * p.splits * p.groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  kern<<<(unsigned)blocks, 32 * p.warps_m * p.warps_n, smem, stream>>>(
      static_cast<const bf*>(h_prev), static_cast<const bf*>(x_pad),
      static_cast<const bf*>(wt), ws, B, H, W, C, Cx, p, epi);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long n = (long long)B * H * C * W;
  cell_reduce_kernel<Epi><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ws, epi, C, W, p.splits, n);
  return cudaGetLastError();
}

// The staged loop's instantiations, one a (wm, wj, narrow chunk, blocks
// an SM).
template <bool kEdge, typename Layout, typename Epi>
cudaError_t dispatch_staged(const void* h_prev, const void* x_pad,
                            const void* wt, float* ws, int B, int H, int W,
                            int C, int Cx, int wm, int wj, int per_sm,
                            const CellPlan& p, cudaStream_t stream, Epi epi) {
  const int cc = p.cc;
#define RSIS_STAGED(WM_, J_, N_, PB_)                                         \
  if (wm == WM_ && wj == J_ && (cc == 8) == N_ && per_sm == PB_)              \
    return launch_staged<WM_, J_, N_, PB_, kEdge, Layout>(                    \
        h_prev, x_pad, wt, ws, B, H, W, C, Cx, p, stream, epi);
  RSIS_STAGED(1, 1, false, 1) RSIS_STAGED(1, 2, false, 1)
  RSIS_STAGED(1, 4, false, 1) RSIS_STAGED(2, 1, false, 1)
  RSIS_STAGED(2, 2, false, 1) RSIS_STAGED(2, 4, false, 1)
  RSIS_STAGED(4, 1, false, 1) RSIS_STAGED(4, 2, false, 1)
  RSIS_STAGED(1, 1, true, 1) RSIS_STAGED(1, 2, true, 1)
  RSIS_STAGED(2, 1, true, 1) RSIS_STAGED(2, 2, true, 1)
  RSIS_STAGED(4, 1, true, 1) RSIS_STAGED(4, 2, true, 1)
  RSIS_STAGED(1, 1, false, 2) RSIS_STAGED(1, 2, false, 2)
  RSIS_STAGED(1, 4, false, 2) RSIS_STAGED(2, 1, false, 2)
  RSIS_STAGED(2, 2, false, 2) RSIS_STAGED(4, 1, false, 2)
  RSIS_STAGED(1, 1, true, 2) RSIS_STAGED(1, 2, true, 2)
  RSIS_STAGED(2, 1, true, 2) RSIS_STAGED(2, 2, true, 2)
  RSIS_STAGED(4, 1, true, 2)
#undef RSIS_STAGED
  return cudaErrorInvalidValue;
}

// The staged loop as the plan cuts it (bf16 operands in Layout): warp
// tiles of wm m-tiles x wj channel blocks, per_sm blocks an SM, the rest
// of the plan in p; ws holds at least splits * B * H * 4C * W floats where
// splits > 1. W a multiple of 8, or any W with kEdgeOk (the edge variant;
// RowMajorLayout only). Returns cudaErrorInvalidValue for a plan or
// operands the kernel does not take.
template <typename Layout = RowMajorLayout, bool kEdgeOk = false,
          typename Epi>
cudaError_t launch_cell_staged(const void* h_prev, const void* x_pad,
                               const void* wt, float* ws, long long ws_floats,
                               int B, int H, int W, int C, int Cx, int wm,
                               int wj, int per_sm, const CellPlan& p,
                               cudaStream_t stream, Epi epi) {
  const int ct = 8 * wj * p.warps_n;
  const long long units =
      (long long)B * ((H + p.rows - 1) / (p.rows > 0 ? p.rows : 1)) *
      ((W + p.tw - 1) / (p.tw > 0 ? p.tw : 1));
  const int cc = p.cc;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cx < 0 || C % 8 || Cx % 8 ||
      (W % 8 && !kEdgeOk) || (wm != 1 && wm != 2 && wm != 4) ||
      (wj != 1 && wj != 2 && wj != 4) || wm * wj > 8 || p.warps_m < 1 ||
      p.warps_n < 1 || p.warps_m * p.warps_n > 8 || C % ct ||
      p.rows < 1 || p.tw < 16 || p.tw % 16 ||
      p.rows * p.tw != 16 * wm * p.warps_m ||
      (cc != 8 && cc != 16 && cc != 32 && cc != 64) || C % cc || Cx % cc ||
      (cc == 8 && wj > 2) || (p.stages != 2 && p.stages != 3) ||
      p.splits < 1 || ((Cx + C) / cc) % p.splits || p.groups < 1 ||
      p.groups > units || (Cx > 0) != (x_pad != nullptr) ||
      (per_sm != 1 && (per_sm != 2 || wm * wj > 4)) ||
      (p.splits > 1 &&
       (ws == nullptr ||
        ws_floats < (long long)p.splits * B * H * 4 * C * W)))
    return cudaErrorInvalidValue;
  if constexpr (kEdgeOk) {
    if (W % 8)
      return dispatch_staged<true, Layout>(h_prev, x_pad, wt, ws, B, H, W, C,
                                           Cx, wm, wj, per_sm, p, stream,
                                           epi);
  }
  return dispatch_staged<false, Layout>(h_prev, x_pad, wt, ws, B, H, W, C,
                                        Cx, wm, wj, per_sm, p, stream, epi);
}

}  // namespace rsis
