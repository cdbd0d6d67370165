// Fused mask head for Hopper (sm_90a): conv3x3 -> 1 channel of the
// align-corners 2x bilinear upsample of the finest hidden state, + bias.
//
// Replaces: rsis_tpu/ops/pallas_mask_head.py::_head_call (kernel bodies
// _head_kernel and _head_kernel_vpu). One kernel covers both tails: the
// dense column-interpolation matmul, the lane rolls and the int32 packing
// of bf16 pairs only fitted the TPU's matrix unit and its 32-bit lanes.
//
// Computes, for h with W contiguous and batch, channel and row strides
// given in elements ((B, H, C, W) of the row-major decode, or (B, C, H, W)
// of the plain decoder) and output (B, 2H, 2W):
//   out[oy, ox] = bias + sum_{dy,dx,c} k[dy,dx,c] * U(h_c)[oy+dy-1, ox+dx-1]
// where U is the align-corners 2x interpolation and the conv's SAME
// padding is zero OUTSIDE the upsampled grid (not a clamp of the input).
// U has two taps per axis with closed-form phase weights (n = H or W):
//   U[2m]   = a[m] z[m-1] + b[m] z[m],   a[m] = m / (2n - 1),       b = 1 - a
//   U[2m+1] = c[m] z[m] + d[m] z[m+1],   d[m] = (n-1-m) / (2n - 1), c = 1 - d
// so output rows 2m and 2m+1 read input rows m-1, m and m+1 only:
//   row 2m   = c[m-1] z0[m-1] + d[m-1] z0[m] + a[m] z1[m-1] + b[m] z1[m]
//            + c[m] z2[m] + d[m] z2[m+1]
//   row 2m+1 = a[m] z0[m-1] + b[m] z0[m] + c[m] z1[m] + d[m] z1[m+1]
//            + a[m+1] z2[m] + b[m+1] z2[m+1]
// (z_dy the dy taps' values; c[-1] = d[-1] = 0 and a[n] = b[n] = 0 stand
// for the upsampled rows -1 and 2n outside the grid), and the same along
// the columns (pallas_mask_head.py's _head_kernel_vpu docstring).
//
// What bounds it on the card: device-memory bytes. Per image it reads
// H*W*C input values and writes 4*H*W outputs (2.1 MB in, 1.0 MB out at
// 256x512x8 bf16) for about 132 fp32 FMAs per input pixel at C = 8.
//
// Design against that bound: one pass, every stage in registers. A
// thread owns V consecutive input columns and walks down its block's R
// input rows (plus one halo row above and below):
//   1. each row's C channels arrive as one V-wide load per channel (8 or
//      16 bytes), the next two rows' already in flight while the current
//      row is contracted into its 9 tap values (9 C FMAs a column; the (9, C)
//      tap weights are read as warp-wide broadcasts from shared memory,
//      staged once per block);
//   2. the row stage adds those taps into the dy-summed sums of the output
//      -row pairs that the row feeds (2 phases x 3 dx x V each), so two
//      pairs stay in registers and the row finishes one pair;
//   3. the column stage of a finished pair takes the dx sums of columns
//      n-1 and n+1 from the neighbouring lanes by shuffles, and at a warp's
//      edge from the neighbouring warp through a 128-byte exchange in
//      shared memory (one barrier a row); it adds the bias and stores both
//      output rows' 2V values as vectors.
// Device memory sees each input value once plus the strips' halo rows
// (2 / R); no table, tap plane or row-stage plane goes through shared
// memory. The block covers a whole row when 32 x warps x V >= W; wider
// rows are cut into strips whose two edge lanes are halo lanes (loaded and
// contracted, not stored). Each output pixel is written by one thread in
// a fixed order, so two launches are bit-identical. Everything accumulates
// in fp32 and rounds once to the output dtype. The plan (V, R, warps) comes
// from rsis_tpu_torch/ops/mask_head.py::mask_head_plan.
//
// A slab of an H-sharded image (rsis_tpu_torch/evals/streaming.py): the H
// rows at hs are rows row0 .. row0 + H - 1 of an image of HG rows, with
// the halo rows row0 - 1 and row0 + H one row stride before and after them
// in memory where they lie inside the image. Rows are weighed by their
// global index m = r + row0 over n = HG and read where 0 <= m < HG, so the
// slab's outputs are the full image's rows 2 row0 .. 2 (row0 + H) - 1; the
// unsharded head is row0 = 0, HG = H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;     // channels of one load item
constexpr int kMaxWarps = 8;  // warps a block

// One V-wide load of a row's columns: its register type and its values as
// floats. S is float, or unsigned short for the raw bits of a bf16 value.
template <typename S, int V>
struct Lane;
template <>
struct Lane<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* x) {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};
template <>
struct Lane<float, 2> {
  using Raw = float2;
  static __device__ __forceinline__ void unpack(const Raw& r, float* x) {
    x[0] = r.x;
    x[1] = r.y;
  }
};
template <>
struct Lane<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw& r, float* x) {
    x[0] = r;
  }
};
template <>
struct Lane<unsigned short, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& r, float* x) {
    x[0] = __uint_as_float(r.x << 16);
    x[1] = __uint_as_float(r.x & 0xffff0000u);
    x[2] = __uint_as_float(r.y << 16);
    x[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};
template <>
struct Lane<unsigned short, 2> {
  using Raw = unsigned;
  static __device__ __forceinline__ void unpack(const Raw& r, float* x) {
    x[0] = __uint_as_float(r << 16);
    x[1] = __uint_as_float(r & 0xffff0000u);
  }
};
template <>
struct Lane<unsigned short, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void unpack(const Raw& r, float* x) {
    x[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
  }
};

// the V columns of kChunk channels of one input row
template <typename S, int V>
struct Item {
  typename Lane<S, V>::Raw x[kChunk];
};

struct Geom {
  int B, H, C, W;
  long long sb, sc, sr;  // input strides in elements; W contiguous
  int row0, HG;          // global row of row 0 and the image's height
  int rows;              // output-row pairs (input rows) a block
  int row_strips;        // ceil(H / rows)
  int col_strips;        // column strips of a row
  int col_step;          // columns between strips (halo strips only)
};

template <typename S, int V>
__device__ __forceinline__ void load_item(Item<S, V>& it, const S* row,
                                          long long sc, int c0, int C,
                                          bool ok) {
  using Raw = typename Lane<S, V>::Raw;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (ok && c0 + j < C)
      it.x[j] = __ldg(reinterpret_cast<const Raw*>(row + (c0 + j) * sc));
    else
      it.x[j] = Raw{};
  }
}

// z[t][i] += sum_j k[t][c0 + j] * x[j][i]; kwc holds the chunk's taps as
// [tap][kChunk], read as two broadcast 16-byte loads a tap
template <typename S, int V>
__device__ __forceinline__ void contract(const Item<S, V>& it,
                                         const float* kwc,
                                         float (&z)[9][V]) {
  float x[kChunk][V];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) Lane<S, V>::unpack(it.x[j], x[j]);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float4 k0 = reinterpret_cast<const float4*>(kwc)[2 * t];
    const float4 k1 = reinterpret_cast<const float4*>(kwc)[2 * t + 1];
    const float k[kChunk] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) z[t][i] = fmaf(k[j], x[j][i], z[t][i]);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// a thread's 2V outputs of one row, rounded once, in 16-byte stores or
// one narrower store
__device__ __forceinline__ void store_out(float* dst, const float (&o)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store_out(float* dst, const float (&o)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_out(float* dst, const float (&o)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
}
__device__ __forceinline__ void store_out(unsigned short* dst,
                                          const float (&o)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                 pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
}
__device__ __forceinline__ void store_out(unsigned short* dst,
                                          const float (&o)[4]) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
}
__device__ __forceinline__ void store_out(unsigned short* dst,
                                          const float (&o)[2]) {
  *reinterpret_cast<unsigned*>(dst) = pack_bf16(o[0], o[1]);
}

template <typename S, int V>
__global__ void __launch_bounds__(kMaxWarps * 32)
mask_head_kernel(const S* __restrict__ hs, const float* __restrict__ wt,
                 const float* __restrict__ bias, S* __restrict__ out,
                 const Geom g) {
  extern __shared__ __align__(16) float kw[];  // [chunk][tap][kChunk]
  // edge sums of each warp, two slots used in turn: [warp][0] its first
  // column's (y1, y2), [warp][1] its last column's (y0, y1), both phases
  __shared__ float xch[2][kMaxWarps][2][4];
  const int n_chunks = (g.C + kChunk - 1) / kChunk;
  for (int i = threadIdx.x; i < n_chunks * 9 * kChunk; i += blockDim.x) {
    const int j = i % kChunk, t = (i / kChunk) % 9;
    const int c = i / (9 * kChunk) * kChunk + j;
    kw[i] = c < g.C ? wt[c * 9 + t] : 0.0f;
  }
  __syncthreads();

  const int cs = blockIdx.x % g.col_strips;
  const int rs = blockIdx.x / g.col_strips % g.row_strips;
  const int b = blockIdx.x / (g.col_strips * g.row_strips);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const bool halo = g.col_strips > 1;
  const int n0 = (halo ? cs * g.col_step - V : 0) + threadIdx.x * V;
  const bool col_in = n0 >= 0 && n0 < g.W;
  const bool owner =
      col_in && (!halo || (threadIdx.x > 0 && threadIdx.x + 1 < blockDim.x));

  // column weights: A[i] = a[n0 + i], D[i] = d[n0 - 1 + i] (zero outside
  // the image), Bw = 1 - A, Cw = 1 - D (c[-1] and b[W] meet zero columns)
  const float winv = 1.0f / static_cast<float>(2 * g.W - 1);
  float A[V + 1], Bw[V + 1], Cw[V + 1], D[V + 1];
#pragma unroll
  for (int i = 0; i <= V; ++i) {
    const int n = n0 + i, m = n0 - 1 + i;
    A[i] = n >= 0 && n < g.W ? static_cast<float>(n) * winv : 0.0f;
    D[i] = m >= 0 && m < g.W ? static_cast<float>(g.W - 1 - m) * winv : 0.0f;
    Bw[i] = 1.0f - A[i];
    Cw[i] = 1.0f - D[i];
  }

  const int r0 = rs * g.rows;
  const int m_last = min(r0 + g.rows, g.H) - 1;
  const int r_end = m_last + 1;
  const float hinv = 1.0f / static_cast<float>(2 * g.HG - 1);
  const S* base = hs + b * g.sb + (col_in ? n0 : 0);
  S* obase = out + (static_cast<long long>(b) * 2 * g.H) * 2 * g.W +
             (owner ? 2 * n0 : 0);
  const float b0 = bias[0];

  // the next two load items (a row's chunk of kChunk channels), in
  // flight; (fr, fc) is the item the next fetch loads
  Item<S, V> buf[2];
  int fr = r0 - 1, fc = 0;
  auto fetch = [&](Item<S, V>& it) {
    if (fr > r_end) return;
    const bool ok = col_in && fr + g.row0 >= 0 && fr + g.row0 < g.HG;
    load_item(it, ok ? base + fr * g.sr : base, g.sc, fc * kChunk, g.C, ok);
    if (++fc == n_chunks) {
      fc = 0;
      ++fr;
    }
  };
  fetch(buf[0]);
  fetch(buf[1]);
  int parity = 0;

  // One input row r. P holds the pair of output rows 2(r-1), 2(r-1)+1,
  // Q the pair of row r ([phase][dx][column], dy already summed). Row r
  // completes P, whose column stage then stores it, and P's registers
  // take up pair r+1: the next row swaps the roles of P and Q.
  auto row = [&](int r, float(&P)[2][3][V], float(&Q)[2][3][V]) {
    const int m = r + g.row0;  // the row's index in the image
    const bool in = m >= 0 && m < g.HG;
    float z[9][V];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int i = 0; i < V; ++i) z[t][i] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const Item<S, V> cur = buf[0];
      buf[0] = buf[1];
      fetch(buf[1]);
      if (in) contract(cur, kw + ch * 9 * kChunk, z);
    }
    // the row weights: a[r+1] (0 past the last row), a, b, c, d at r and
    // d[r-1] (0 above the first row)
    const float a1 = m + 1 < g.HG ? static_cast<float>(m + 1) * hinv : 0.0f;
    const float br = 1.0f - static_cast<float>(m) * hinv;
    const float dr = static_cast<float>(g.HG - 1 - m) * hinv;
    const float cr = 1.0f - dr;
    const float dm = m >= 1 ? static_cast<float>(g.HG - m) * hinv : 0.0f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z0 = z[dx][i], z1 = z[3 + dx][i], z2 = z[6 + dx][i];
        if (in && r - 1 >= r0) {  // row r is pair r-1's row m+1
          P[0][dx][i] = fmaf(dm, z2, P[0][dx][i]);
          P[1][dx][i] = fmaf(br, z2, fmaf(dm, z1, P[1][dx][i]));
        }
        if (in && r >= r0) {  // pair r's row m
          Q[0][dx][i] = fmaf(cr, z2, fmaf(br, z1, fmaf(dm, z0, Q[0][dx][i])));
          Q[1][dx][i] = fmaf(a1, z2, fmaf(cr, z1, fmaf(br, z0, Q[1][dx][i])));
        }
      }
    if (r - 1 >= r0) {  // pair r-1 is complete: the column stage
      // the left neighbour's last column (y0, y1) and the right
      // neighbour's first column (y1, y2), per phase
      float lf[2][2], rt[2][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        lf[p][0] = __shfl_up_sync(0xffffffffu, P[p][0][V - 1], 1);
        lf[p][1] = __shfl_up_sync(0xffffffffu, P[p][1][V - 1], 1);
        rt[p][0] = __shfl_down_sync(0xffffffffu, P[p][1][0], 1);
        rt[p][1] = __shfl_down_sync(0xffffffffu, P[p][2][0], 1);
      }
      if (n_warps > 1) {
        float(*x)[2][4] = xch[parity];
        if (lane == 0) {
          x[warp][0][0] = P[0][1][0];
          x[warp][0][1] = P[0][2][0];
          x[warp][0][2] = P[1][1][0];
          x[warp][0][3] = P[1][2][0];
        }
        if (lane == 31) {
          x[warp][1][0] = P[0][0][V - 1];
          x[warp][1][1] = P[0][1][V - 1];
          x[warp][1][2] = P[1][0][V - 1];
          x[warp][1][3] = P[1][1][V - 1];
        }
        __syncthreads();
        if (lane == 0) {
          const bool has = warp > 0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            lf[k >> 1][k & 1] = has ? x[warp - 1][1][k] : 0.0f;
        }
        if (lane == 31) {
          const bool has = warp + 1 < n_warps;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            rt[k >> 1][k & 1] = has ? x[warp + 1][0][k] : 0.0f;
        }
        parity ^= 1;
      } else {
        if (lane == 0) lf[0][0] = lf[0][1] = lf[1][0] = lf[1][1] = 0.0f;
        if (lane == 31) rt[0][0] = rt[0][1] = rt[1][0] = rt[1][1] = 0.0f;
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float o[2 * V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float y0m = i ? P[p][0][i - 1] : lf[p][0];
          const float y1m = i ? P[p][1][i - 1] : lf[p][1];
          const float y1p = i + 1 < V ? P[p][1][i + 1] : rt[p][0];
          const float y2p = i + 1 < V ? P[p][2][i + 1] : rt[p][1];
          float e = fmaf(Cw[i], y0m, b0);  // c[n-1], d[n-1]
          e = fmaf(D[i], P[p][0][i], e);
          e = fmaf(A[i], y1m, e);  // a[n], b[n]
          e = fmaf(Bw[i], P[p][1][i], e);
          e = fmaf(Cw[i + 1], P[p][2][i], e);  // c[n], d[n]
          o[2 * i] = fmaf(D[i + 1], y2p, e);
          float f = fmaf(A[i], y0m, b0);
          f = fmaf(Bw[i], P[p][0][i], f);
          f = fmaf(Cw[i + 1], P[p][1][i], f);
          f = fmaf(D[i + 1], y1p, f);
          f = fmaf(A[i + 1], P[p][2][i], f);  // a[n+1], b[n+1]
          o[2 * i + 1] = fmaf(Bw[i + 1], y2p, f);
        }
        if (owner) store_out(obase + (2LL * (r - 1) + p) * 2 * g.W, o);
      }
    }
    // pair r+1 starts from its row m-1
    const bool next = in && r + 1 <= m_last;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        P[0][dx][i] = next ? fmaf(a1, z[3 + dx][i], cr * z[dx][i]) : 0.0f;
        P[1][dx][i] = next ? a1 * z[dx][i] : 0.0f;
      }
  };

  float P[2][3][V], Q[2][3][V];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < V; ++i) P[p][dx][i] = Q[p][dx][i] = 0.0f;
  for (int r = r0 - 1; r <= r_end; r += 2) {
    row(r, P, Q);
    if (r + 1 <= r_end) row(r + 1, Q, P);
  }
}

// strips of one row for `warps` warps of V columns: (strips, step)
void col_strips(int W, int V, int warps, int& strips, int& step) {
  const int slots = 32 * warps;
  if (slots * V >= W) {
    strips = 1;
    step = 0;
  } else {
    step = (slots - 2) * V;
    strips = (W + step - 1) / step;
  }
}

template <typename S, int V>
cudaError_t launch(const void* hs, const float* wt, const float* bias,
                   void* out, Geom g, int warps, cudaStream_t stream) {
  const int n_chunks = (g.C + kChunk - 1) / kChunk;
  const size_t smem = static_cast<size_t>(n_chunks) * 9 * kChunk *
                      sizeof(float);
  const size_t static_smem = sizeof(float) * 2 * kMaxWarps * 2 * 4;
  if (smem + static_smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = mask_head_kernel<S, V>;
  if (smem + static_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      static_cast<long long>(g.B) * g.row_strips * g.col_strips;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), 32 * warps, smem, stream>>>(
      static_cast<const S*>(hs), wt, bias, static_cast<S*>(out), g);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_v(const void* hs, const float* wt, const float* bias,
                     void* out, const Geom& g, int v, int warps,
                     cudaStream_t s) {
  switch (v) {
    case 4: return launch<S, 4>(hs, wt, bias, out, g, warps, s);
    case 2: return launch<S, 2>(hs, wt, bias, out, g, warps, s);
    case 1: return launch<S, 1>(hs, wt, bias, out, g, warps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// hs with W contiguous and strides sb, sc, sr (elements) for batch,
// channel and row, out (B, 2H, 2W) contiguous, both in dtype (0 = float32,
// 1 = bfloat16); weight (1, C, 3, 3) float32 contiguous (tap = dy * 3 +
// dx); bias one float32. The plan: v columns a thread (1, 2 or 4; W, the
// strides and hs's address aligned to v elements), rows input rows a
// block, warps (1-8) a block. row0 and HG: the slab's first row and the
// image's height (0 and H unsharded; the halo rows row0 - 1 and row0 + H
// that lie in the image at hs - sr and hs + H sr). Returns the launch's
// cudaError_t (0 on success).
extern "C" int rsis_mask_head(const void* hs, const void* weight,
                              const void* bias, void* out, int B, int H,
                              int C, int W, long long sb, long long sc,
                              long long sr, int dtype, int v, int rows,
                              int warps, int row0, int HG, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || W <= 0 || rows <= 0 || warps <= 0 ||
      warps > kMaxWarps || (v != 1 && v != 2 && v != 4) || row0 < 0 ||
      row0 + H > HG)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t esize = dtype == 0 ? 4 : 2;
  if (W % v || sb % v || sc % v || sr % v ||
      reinterpret_cast<uintptr_t>(hs) % (v * esize))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{B, H, C, W, sb, sc, sr, row0, HG, rows, (H + rows - 1) / rows,
         1, 0};
  col_strips(W, v, warps, g.col_strips, g.col_step);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(weight);
  const float* bf = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == 0)
    err = launch_v<float>(hs, wf, bf, out, g, v, warps, s);
  else if (dtype == 1)
    err = launch_v<unsigned short>(hs, wf, bf, out, g, v, warps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
