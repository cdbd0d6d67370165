// Align-corners bilinear upsample of the row-major decode's hidden state
// into the cell kernel's zero-ringed input, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package leaves this layer to XLA:
// rsis_tpu/models/rowmajor_decoder.py::_upsample_rowmajor, the einsum pair
// "oh,bhcw->bocw" then "bocw,pw->bocp" against dense interpolation
// matrices (lines 147-150), each accumulated in fp32 and cast to the
// compute dtype. Its plain version, ops/upsample.py::upsample_rowmajor_ref,
// runs the same pair as two fp32 matrix products with casts around them.
//
// Computes, for x (B, h, C, w) and the output (B, Ho, C, Wo), where
// Ho = out_h + 2 and Wo = out_w + 2 with the zero halo ring (pad) and
// out_h, out_w without it:
//   y[c, j]      = round(w_lo(o) x[lo(o), c, j] + w_hi(o) x[hi(o), c, j])
//   out[o, c, k] = round(w_lo(k) y[c, lo(k)]    + w_hi(k) y[c, hi(k)])
// rows first, then columns, each in fp32 and rounded once to the dtype;
// the ring's rows and columns are 0. The taps (lo, hi, w_lo, w_hi) of each
// output row and column are ops/upsample.py::interp_taps, the nonzero
// entries of the dtype-rounded interpolation matrices that the plain
// version multiplies by. With bf16 operands each product is exact in fp32
// and the two-term sum rounds once, as the matrix product's does, so the
// output is bit-identical to the plain version's; in fp32 the products
// round too, and the sum may differ from the product's by its order.
//
// What bounds it on the card: device-memory bytes, about 0.5 operations a
// byte. At the Cityscapes forward (B=32, 512x1024) the four upsamples of a
// decode step read 31.5 M and write 129.0 M bf16 elements, 321 MB: 0.096
// ms a step at 3.35 TB/s. The plain version moves about nine times these
// bytes (fp32 copies of its input, intermediate and output) and spends its
// multiply-adds almost all on zeros.
//
// Design against that bound: each input element is read from device
// memory once and each output element written once, with nothing in
// between. One block takes one padded output row o of one image:
//   1. a ring row stores zeros and returns;
//   2. the block reads the input rows lo(o) and hi(o) (C w contiguous
//      elements each, 16-byte loads; neighbouring output rows share them,
//      so the re-reads hit L2) and stages their interpolation, rounded to
//      the dtype, in shared memory (8 KB at the Cityscapes cells);
//   3. its threads write the flat output row (C Wo elements): a thread
//      takes two neighbouring output columns k, k + 1 (where Wo is even:
//      both at every Cityscapes and Pascal cell) and kGroup channels, loads
//      their taps once (neighbouring lanes, neighbouring columns: coalesced
//      loads), reads its four staged values a channel and stores the
//      channel's two elements in one 4-byte (bf16) or 8-byte (fp32) store;
//      each store instruction of a warp covers consecutive columns. Odd Wo
//      takes one column a thread. Two columns a thread cut a decode step's
//      four launches at B=32 from 0.201 to 0.161 ms (one column a thread;
//      the bound 0.096, one H100 at 700 W).
// Rows wider than kSmemBytes of staged channels are staged kSmemBytes at a
// time. Each output element is written by one thread, so launches are
// bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;              // channels a column-stage item
constexpr int kSmemBytes = 48 * 1024;  // staged row values a pass, at most

struct Taps {
  int lo, hi;
  float wl, wh;
};

// taps i of a (n, 4) int32 table: lo, hi and the weights' float32 bits
__device__ __forceinline__ Taps taps_at(const int4* __restrict__ t, int i) {
  const int4 v = __ldg(t + i);
  return {v.x, v.y, __int_as_float(v.z), __int_as_float(v.w)};
}

// w_lo a + w_hi b in fp32, rounded once after the w_lo product: exact
// products in bf16, the matrix product's k-ordered sum in fp32
__device__ __forceinline__ float lerp(const Taps& t, float a, float b) {
  return __fmaf_rn(t.wh, b, __fmul_rn(t.wl, a));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// one element type: float, or unsigned short for the raw bits of a bf16;
// kV elements a 16-byte vector
template <typename S>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kV = 4;
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
  __device__ static void unpack(const uint4& v, float (&f)[kV]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[kV]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  // elements p[0], p[1] (8-byte aligned) in one store
  __device__ static void put2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Elem<unsigned short> {
  static constexpr int kV = 8;
  __device__ static float get(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  __device__ static unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static void unpack(const uint4& v, float (&f)[kV]) {
    f[0] = bf16_lo(v.x);
    f[1] = bf16_hi(v.x);
    f[2] = bf16_lo(v.y);
    f[3] = bf16_hi(v.y);
    f[4] = bf16_lo(v.z);
    f[5] = bf16_hi(v.z);
    f[6] = bf16_lo(v.w);
    f[7] = bf16_hi(v.w);
  }
  __device__ static uint4 pack(const float (&f)[kV]) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
  // elements p[0], p[1] (4-byte aligned) in one store
  __device__ static void put2(unsigned short* p, float a, float b) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// zeros over an output row's n elements at o (16-byte aligned where n is
// a multiple of kV: out is)
template <typename S>
__device__ void zero_row(S* __restrict__ o, int n) {
  constexpr int V = Elem<S>::kV;
  if (n % V == 0) {
    for (int i = threadIdx.x * V; i < n; i += kThreads * V)
      *reinterpret_cast<uint4*>(o + i) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) o[i] = S(0);
  }
}

// ys[i] = round(lerp(t, a[i], b[i])) for i < n: the row stage
template <typename S>
__device__ void stage_rows(const S* __restrict__ a, const S* __restrict__ b,
                           S* ys, int n, const Taps& t) {
  using E = Elem<S>;
  constexpr int V = E::kV;
  if (n % V == 0 && aligned16(a) && aligned16(b)) {
    for (int i = threadIdx.x * V; i < n; i += kThreads * V) {
      float fa[V], fb[V], fy[V];
      E::unpack(__ldg(reinterpret_cast<const uint4*>(a + i)), fa);
      E::unpack(__ldg(reinterpret_cast<const uint4*>(b + i)), fb);
#pragma unroll
      for (int j = 0; j < V; ++j) fy[j] = lerp(t, fa[j], fb[j]);
      *reinterpret_cast<uint4*>(ys + i) = E::pack(fy);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      ys[i] = E::put(lerp(t, E::get(a[i]), E::get(b[i])));
  }
}

// the column stage of nc staged channels (ys, w values a channel) into o
// (nc channels of Wo elements): item (g, k) is column k of channels
// g kGroup .. g kGroup + kGroup - 1; a thread's items lie kThreads apart
template <typename S>
__device__ void store_columns(const S* ys, const int4* __restrict__ col_taps,
                              S* __restrict__ o, int nc, int w, int Wo,
                              int pad) {
  using E = Elem<S>;
  const int groups = (nc + kGroup - 1) / kGroup;
  const int dg = kThreads / Wo, dk = kThreads % Wo;
  int g = threadIdx.x / Wo, k = threadIdx.x % Wo;
  while (g < groups) {
    const int c0 = g * kGroup;
    S* dst = o + static_cast<size_t>(c0) * Wo + k;
    if (pad && (k == 0 || k == Wo - 1)) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c0 + c < nc) dst[static_cast<size_t>(c) * Wo] = S(0);
    } else {
      const Taps t = taps_at(col_taps, k);
      const S* y = ys + c0 * w;
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c0 + c < nc)
          dst[static_cast<size_t>(c) * Wo] = E::put(
              lerp(t, E::get(y[c * w + t.lo]), E::get(y[c * w + t.hi])));
    }
    g += dg;
    k += dk;
    if (k >= Wo) {
      k -= Wo;
      ++g;
    }
  }
}

// store_columns where Wo is even: item (g, m) is columns 2m and 2m + 1,
// stored together (o, a channel's first element, is aligned to two: out
// is)
template <typename S>
__device__ void store_column_pairs(const S* ys,
                                   const int4* __restrict__ col_taps,
                                   S* __restrict__ o, int nc, int w, int Wo,
                                   int pad) {
  using E = Elem<S>;
  const int half = Wo / 2;
  const int groups = (nc + kGroup - 1) / kGroup;
  const int dg = kThreads / half, dm = kThreads % half;
  int g = threadIdx.x / half, m = threadIdx.x % half;
  while (g < groups) {
    const int c0 = g * kGroup, k = 2 * m;
    // a ring column's taps are zeros: read, and the value replaced by 0
    const bool ring0 = pad && k == 0, ring1 = pad && k + 1 == Wo - 1;
    const Taps t0 = taps_at(col_taps, k), t1 = taps_at(col_taps, k + 1);
    const S* y = ys + c0 * w;
    S* dst = o + static_cast<size_t>(c0) * Wo + k;
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      if (c0 + c < nc) {
        const S* yc = y + c * w;
        const float v0 = lerp(t0, E::get(yc[t0.lo]), E::get(yc[t0.hi]));
        const float v1 = lerp(t1, E::get(yc[t1.lo]), E::get(yc[t1.hi]));
        E::put2(dst + static_cast<size_t>(c) * Wo, ring0 ? 0.f : v0,
                ring1 ? 0.f : v1);
      }
    }
    g += dg;
    m += dm;
    if (m >= half) {
      m -= half;
      ++g;
    }
  }
}

// block (o, b): padded output row o of image b; chunk channels staged a
// pass (C where a row's values fit kSmemBytes)
template <typename S>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const S* __restrict__ x, const int4* __restrict__ row_taps,
                const int4* __restrict__ col_taps, S* __restrict__ out, int h,
                int C, int w, int Ho, int Wo, int pad, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* ys = reinterpret_cast<S*>(smem);
  const int r = blockIdx.x, b = blockIdx.y;
  S* orow = out + (static_cast<size_t>(b) * Ho + r) * C * Wo;
  if (pad && (r == 0 || r == Ho - 1)) {
    zero_row(orow, C * Wo);
    return;
  }
  const Taps t = taps_at(row_taps, r);
  const size_t plane = static_cast<size_t>(C) * w;
  const S* xlo = x + (static_cast<size_t>(b) * h + t.lo) * plane;
  const S* xhi = x + (static_cast<size_t>(b) * h + t.hi) * plane;
  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int nc = min(chunk, C - c0);
    if (c0 > 0) __syncthreads();  // the last pass's values are read
    stage_rows(xlo + static_cast<size_t>(c0) * w,
               xhi + static_cast<size_t>(c0) * w, ys, nc * w, t);
    __syncthreads();
    S* o = orow + static_cast<size_t>(c0) * Wo;
    if (Wo % 2 == 0)
      store_column_pairs(ys, col_taps, o, nc, w, Wo, pad);
    else
      store_columns(ys, col_taps, o, nc, w, Wo, pad);
  }
}

template <typename S>
cudaError_t launch(const void* x, const void* row_taps, const void* col_taps,
                   void* out, int B, int h, int C, int w, int Ho, int Wo,
                   int pad, cudaStream_t stream) {
  const size_t row = static_cast<size_t>(w) * sizeof(S);
  if (row > static_cast<size_t>(kSmemBytes)) return cudaErrorInvalidValue;
  const int chunk = min(C, static_cast<int>(kSmemBytes / row));
  const dim3 grid(Ho, B);
  upsample_kernel<S><<<grid, kThreads, chunk * row, stream>>>(
      static_cast<const S*>(x), static_cast<const int4*>(row_taps),
      static_cast<const int4*>(col_taps), static_cast<S*>(out), h, C, w, Ho,
      Wo, pad, chunk);
  return cudaGetLastError();
}

}  // namespace

// x (B, h, C, w) and out (B, Ho, C, Wo), contiguous, in elements of
// elem_bytes bytes (4 float32, 2 bfloat16), out 16-byte aligned;
// row_taps (Ho, 4) and col_taps (Wo, 4) int32, 16-byte aligned: lo, hi
// (input rows or columns) and the float32 bits of their weights. pad 1:
// the first and last output row and column are the zero ring (their taps
// all zeros). B <= 65535; one channel's row (w elements) at most 48 KB.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_upsample(const void* x, const void* row_taps,
                             const void* col_taps, void* out, int B, int h,
                             int C, int w, int Ho, int Wo, int pad,
                             int elem_bytes, void* stream) {
  if (B < 1 || B > 65535 || h < 1 || C < 1 || w < 1 || Ho < 1 + 2 * pad ||
      Wo < 1 + 2 * pad || (pad != 0 && pad != 1) ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(row_taps) % 16 ||
      reinterpret_cast<uintptr_t>(col_taps) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 4)
    err = launch<float>(x, row_taps, col_taps, out, B, h, C, w, Ho, Wo, pad,
                        s);
  else if (elem_bytes == 2)
    err = launch<unsigned short>(x, row_taps, col_taps, out, B, h, C, w, Ho,
                                 Wo, pad, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
