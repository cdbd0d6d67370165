// Nearest-neighbour affine warp with the horizontal flip folded in, for
// Hopper (sm_90a): the geometric core of the train step's augmentation.
//
// Replaces: rsis_tpu/ops/pallas_warp.py::affine_warp_planes (kernel bodies
// _pass1_kernel and _pass2_kernel). The TPU kernel is two passes of
// one-hot matrix products with shifted selects, because a gather on the
// TPU pays per row; on Hopper a gather is a plain load, so this kernel is
// the direct form.
//
// Computes, per image b and output pixel (r, c), from the coefficients
// p, q, m, u, v, o, flag of ops/warp.py::_coef_from_matrices:
//   R  = clamp(rint(p*r + (q*c + m)), 0, H-1)
//   C  = clamp(rint(v*r + (u*c + o)), 0, W-1);  C' = flag ? (W-1) - C : C
//   img_out[b, r, c, :] = img[b, R, C', :];  ids_out[b, r, c] = ids[b, R, C']
// The image is NHWC (the train step's layout: no transpose, no
// concatenation with the id plane) and the id plane (B, H, W) uint8. Each
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction) in the parenthesisation above, and rintf rounds half to
// even, so the indices are bit-identical to the plain version in
// ops/warp.py, which runs the same fp32 operations as separate torch ops.
// The payload is copied as bits (2-byte bf16 or 4-byte fp32 elements), so
// it warps exactly.
//
// What bounds it on the card: device-memory bytes. Each output pixel reads
// and writes C elements and one id byte (14 bytes a pixel for a bf16 RGB
// image, 58.7 MB a 32 x 256 x 512 batch) and needs about 10 flops of index
// math.
//
// Why one pixel a thread fell short of that bound: bytes in flight. Such a
// thread issues C 2-byte gathers and one 1-byte gather, about 7 bytes, and
// then its stores; at 2,048 threads an SM that is about 14 KB in flight an
// SM, where the memory's rate times its latency asks for about 25 KB, so
// the kernel waited on latency at about half its bound.
//
// Design against that: a warp owns a segment of 32 V consecutive output
// pixels of one row (V = 16: one segment a 512-pixel row; the store widths
// and the gather come from ops/warp.py::warp_plan):
//   1. lane l computes the source pixels of the segment's pixels l + 32 k,
//      k < V, each with the expression tree above (never stepped along the
//      row, which would round differently);
//   2. then all the segment's gathers are issued before any store: V ids a
//      lane, and the V x C image elements of a lane either as element q of
//      the segment by lane q % 32 (its pixel's source by one shuffle from
//      the lane that computed it), so that each load instruction reads 32
//      consecutive elements and no sector twice, or, where a pixel is 4, 8
//      or 16 bytes and the image's address allows, each of the lane's
//      pixels as one load; V times one pixel's bytes are in flight a lane;
//   3. the warp stages the segment in shared memory in output order (3 KB
//      of bf16 RGB) and, after a __syncwarp, stores it as consecutive
//      16-byte chunks, lane q the chunks q, q + 32, ... (each store
//      instruction 512 contiguous bytes), and its ids the same way;
//      narrower chunks where the row's bytes are not a multiple of 16, and
//      for the last bytes of a row's last segment (W % 32 V pixels).
// C outside 1-4 takes one pixel a thread. The coefficients are read once a
// block into shared memory. Each output byte is written by one thread, so
// launches are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one pixel a thread
constexpr int kWarps = 4;      // segments a block
constexpr int kV = 16;         // pixels a lane, 32 kV a segment
constexpr int kCoef = 10;  // p, q, m, u, v, o, u', v', flag, o'

// the block's image's p, q, m, u, v, o and flag, read once
__device__ __forceinline__ void load_coef(const float* coef, int b,
                                          float* cf) {
  if (threadIdx.x < 7) {
    const int k = threadIdx.x < 6 ? threadIdx.x : 8;
    cf[threadIdx.x] = coef[(size_t)b * kCoef + k];
  }
  __syncthreads();
}

// flat source pixel (within the image) of output pixel (r, c)
__device__ __forceinline__ int source_pixel(const float* cf, int r, int c,
                                            int H, int W) {
  const float rf = (float)r, cl = (float)c;
  const float src_r =
      __fadd_rn(__fmul_rn(cf[0], rf), __fadd_rn(__fmul_rn(cf[1], cl), cf[2]));
  const float src_c =
      __fadd_rn(__fmul_rn(cf[4], rf), __fadd_rn(__fmul_rn(cf[3], cl), cf[5]));
  const int R = (int)fminf(fmaxf(rintf(src_r), 0.f), (float)(H - 1));
  int Cs = (int)fminf(fmaxf(rintf(src_c), 0.f), (float)(W - 1));
  if (cf[6] > 0.f) Cs = (W - 1) - Cs;
  return R * W + Cs;
}

// one pixel's C elements (4, 8 or 16 bytes) into e[0..C) by one load
template <typename T, int C>
__device__ __forceinline__ void load_pixel(const T* p, T* e) {
  constexpr int kBytes = C * (int)sizeof(T);
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16);
  uint32_t w[kBytes / 4];
  if constexpr (kBytes == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (kBytes == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if constexpr (sizeof(T) == 4)
      e[i] = w[i];
    else
      e[i] = (T)(w[i / 2] >> (16 * (i % 2)));
  }
}

// bytes from the staged segment src to dst (both aligned to width bytes):
// lane q the width-byte chunks q, q + 32, ..., then narrower chunks for the
// bytes that are left
__device__ __forceinline__ void store_chunks(uint8_t* dst, const uint8_t* src,
                                             int bytes, int width, int lane) {
  int done = 0;
  if (width >= 16) {
    const int n = bytes / 16;
    for (int q = lane; q < n; q += 32)
      reinterpret_cast<uint4*>(dst)[q] =
          reinterpret_cast<const uint4*>(src)[q];
    done = n * 16;
  }
  if (width >= 8) {
    const int n = (bytes - done) / 8;
    for (int q = lane; q < n; q += 32)
      reinterpret_cast<uint2*>(dst + done)[q] =
          reinterpret_cast<const uint2*>(src + done)[q];
    done += n * 8;
  }
  if (width >= 4) {
    const int n = (bytes - done) / 4;
    for (int q = lane; q < n; q += 32)
      reinterpret_cast<uint32_t*>(dst + done)[q] =
          reinterpret_cast<const uint32_t*>(src + done)[q];
    done += n * 4;
  }
  if (width >= 2) {
    const int n = (bytes - done) / 2;
    for (int q = lane; q < n; q += 32)
      reinterpret_cast<uint16_t*>(dst + done)[q] =
          reinterpret_cast<const uint16_t*>(src + done)[q];
    done += n * 2;
  }
  for (int q = done + lane; q < bytes; q += 32) dst[q] = src[q];
}

// element q = lane + 32 m of the segment belongs to pixel q / C, whose
// source the lane (q / C) % 32 computed: one shuffle, and each load
// instruction reads the next 32 elements; staged in output order
template <typename T, int C>
__device__ __forceinline__ void gather_elements(const T* src_img,
                                                const int (&src)[kV], T* st,
                                                int n, int lane) {
  T e[kV * C];
#pragma unroll
  for (int m = 0; m < kV * C; ++m) {
    const int q = lane + 32 * m;
    const int p = q / C;
    const int p0 = 32 * m / C;  // the instruction's first pixel
    const int k0 = p0 / 32;
    const int mine = lane >= p0 % 32 ? src[k0] : src[min(k0 + 1, kV - 1)];
    const int sp = __shfl_sync(0xffffffffu, mine, p & 31);
    e[m] = __ldg(src_img + (size_t)sp * C + (q - p * C));
  }
#pragma unroll
  for (int m = 0; m < kV * C; ++m)
    if (lane + 32 * m < n * C) st[lane + 32 * m] = e[m];
}

// each of the lane's pixels as one 4-, 8- or 16-byte load, staged in output
// order
template <typename T, int C>
__device__ __forceinline__ void gather_vector(const T* src_img,
                                              const int (&src)[kV], T* st,
                                              int n, int lane) {
  T e[kV * C];
#pragma unroll
  for (int k = 0; k < kV; ++k)
    load_pixel<T, C>(src_img + (size_t)src[k] * C, e + k * C);
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int p = lane + 32 * k;
    if (p >= n) break;
#pragma unroll
    for (int i = 0; i < C; ++i) st[p * C + i] = e[k * C + i];
  }
}

// vec: gather a lane's pixels each as one load (ops/warp.py::WARP_LOADS
// "vector"; only where a pixel is 4, 8 or 16 bytes and the image is aligned
// to that), else element q of the segment by lane q % 32 ("elements")
template <typename T, int C>
__global__ void __launch_bounds__(kWarps * 32)
warp_segment_kernel(const T* __restrict__ img,
                    const uint8_t* __restrict__ ids,
                    const float* __restrict__ coef, T* __restrict__ img_out,
                    uint8_t* __restrict__ ids_out, int H, int W,
                    int img_store, int ids_store, int vec) {
  constexpr int kSeg = 32 * kV;  // pixels a warp
  constexpr int kPixel = C * (int)sizeof(T);
  __shared__ __align__(16) uint8_t stage_img[kWarps][kSeg * kPixel];
  __shared__ __align__(16) uint8_t stage_ids[kWarps][kSeg];
  __shared__ float cf[7];
  const int b = blockIdx.y;
  load_coef(coef, b, cf);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int segs = (W + kSeg - 1) / kSeg;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= H * segs) return;  // whole warps leave together
  const int r = g / segs;
  const int c0 = (g - r * segs) * kSeg;
  const int n = min(kSeg, W - c0);
  const size_t plane = (size_t)b * H * W;
  const T* src_img = img + plane * C;
  const uint8_t* src_ids = ids + plane;
  T* st = reinterpret_cast<T*>(stage_img[warp]);
  // 1. the source pixels of the lane's pixels lane + 32 k (past the row's
  // end: the row's last pixel, gathered and not staged)
  int src[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k)
    src[k] = source_pixel(cf, r, min(c0 + lane + 32 * k, W - 1), H, W);
  // 2. all the gathers, 3. staged in output order
  uint8_t id[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) id[k] = __ldg(src_ids + src[k]);
  if constexpr (kPixel == 4 || kPixel == 8 || kPixel == 16) {
    if (vec)
      gather_vector<T, C>(src_img, src, st, n, lane);
    else
      gather_elements<T, C>(src_img, src, st, n, lane);
  } else {
    gather_elements<T, C>(src_img, src, st, n, lane);
  }
#pragma unroll
  for (int k = 0; k < kV; ++k)
    if (lane + 32 * k < n) stage_ids[warp][lane + 32 * k] = id[k];
  __syncwarp();
  const size_t dst = plane + (size_t)r * W + c0;
  store_chunks(reinterpret_cast<uint8_t*>(img_out + dst * C), stage_img[warp],
               n * kPixel, img_store, lane);
  store_chunks(ids_out + dst, stage_ids[warp], n, ids_store, lane);
}

// one output pixel a thread, for any C
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_pixel_kernel(const T* __restrict__ img, const uint8_t* __restrict__ ids,
                  const float* __restrict__ coef, T* __restrict__ img_out,
                  uint8_t* __restrict__ ids_out, int H, int W, int C) {
  __shared__ float cf[7];
  const int b = blockIdx.y;
  load_coef(coef, b, cf);
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= H * W) return;
  const int r = pix / W;
  const size_t plane = (size_t)b * H * W;
  const size_t src = plane + source_pixel(cf, r, pix - r * W, H, W);
  const size_t dst = plane + pix;
  for (int k = 0; k < C; ++k) img_out[dst * C + k] = __ldg(img + src * C + k);
  ids_out[dst] = __ldg(ids + src);
}

struct Launch {
  const void *img, *ids, *coef;
  void *img_out, *ids_out;
  int B, H, W, C, img_store, ids_store, vec;
  cudaStream_t stream;
};

template <typename T, int C>
cudaError_t launch_segments(const Launch& a) {
  const int segs = (a.W + 32 * kV - 1) / (32 * kV);
  const dim3 grid((a.H * segs + kWarps - 1) / kWarps, a.B);
  warp_segment_kernel<T, C><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.img), static_cast<const uint8_t*>(a.ids),
      static_cast<const float*>(a.coef), static_cast<T*>(a.img_out),
      static_cast<uint8_t*>(a.ids_out), a.H, a.W, a.img_store, a.ids_store,
      a.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Launch& a) {
  switch (a.C) {
    case 1: return launch_segments<T, 1>(a);
    case 2: return launch_segments<T, 2>(a);
    case 3: return launch_segments<T, 3>(a);
    case 4: return launch_segments<T, 4>(a);
  }
  const dim3 grid((a.H * a.W + kThreads - 1) / kThreads, a.B);
  warp_pixel_kernel<T><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.img), static_cast<const uint8_t*>(a.ids),
      static_cast<const float*>(a.coef), static_cast<T*>(a.img_out),
      static_cast<uint8_t*>(a.ids_out), a.H, a.W, a.C);
  return cudaGetLastError();
}

}  // namespace

// img (B, H, W, C) with elements of elem_bytes (2 or 4) bytes, ids
// (B, H, W) uint8, coef (B, 10) float32, all contiguous; the outputs
// contiguous and 16-byte aligned; B <= 65535. C in 1-4: segments of 32 kV
// pixels a warp, with the plan of ops/warp.py::warp_plan: img_store and
// ids_store the bytes of the widest chunk a segment's image elements and
// ids are stored in (dividing the row's bytes), vec 1 to gather a pixel as
// one load (only where a pixel's bytes are 4, 8 or 16 and the image is
// aligned to them). Other C: one pixel a thread, the plan unused. Returns
// the launch's cudaError_t (0 on success).
extern "C" int rsis_warp(const void* img, const void* ids, const void* coef,
                         void* img_out, void* ids_out, int B, int H, int W,
                         int C, int elem_bytes, int img_store, int ids_store,
                         int vec, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const Launch a{img, ids, coef, img_out, ids_out, B, H, W, C, img_store,
                 ids_store, vec, static_cast<cudaStream_t>(stream)};
  if (elem_bytes == 2) return (int)run<uint16_t>(a);
  if (elem_bytes == 4) return (int)run<uint32_t>(a);
  return (int)cudaErrorInvalidValue;
}
