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
// image) and needs about 10 flops of index math.
//
// Design against that bound: one thread per output pixel computes R and C'
// once and copies that pixel of the image and of the id plane; the writes
// of a warp are contiguous, and the reads follow the warp's source pixels,
// which lie on one or two source rows for the small angles of the
// augmentation, so they fall into few cache lines.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCoef = 10;  // p, q, m, u, v, o, u', v', flag, o'

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ img, const uint8_t* __restrict__ ids,
            const float* __restrict__ coef, T* __restrict__ img_out,
            uint8_t* __restrict__ ids_out, int H, int W, int C) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= H * W) return;
  const int r = pix / W;
  const int c = pix - r * W;
  const float* cf = coef + (size_t)b * kCoef;
  const float p = __ldg(cf + 0), q = __ldg(cf + 1), m = __ldg(cf + 2);
  const float u = __ldg(cf + 3), v = __ldg(cf + 4), o = __ldg(cf + 5);
  const float flag = __ldg(cf + 8);
  const float rf = (float)r, cf_ = (float)c;
  const float src_r = __fadd_rn(__fmul_rn(p, rf), __fadd_rn(__fmul_rn(q, cf_), m));
  const float src_c = __fadd_rn(__fmul_rn(v, rf), __fadd_rn(__fmul_rn(u, cf_), o));
  const int R = (int)fminf(fmaxf(rintf(src_r), 0.f), (float)(H - 1));
  int Cs = (int)fminf(fmaxf(rintf(src_c), 0.f), (float)(W - 1));
  if (flag > 0.f) Cs = (W - 1) - Cs;
  const size_t plane = (size_t)b * H * W;
  const size_t src = plane + (size_t)R * W + Cs;
  const size_t dst = plane + pix;
  for (int k = 0; k < C; ++k) img_out[dst * C + k] = img[src * C + k];
  ids_out[dst] = ids[src];
}

template <typename T>
cudaError_t run(const void* img, const void* ids, const void* coef,
                void* img_out, void* ids_out, int B, int H, int W, int C,
                cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  warp_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const uint8_t*>(ids),
      static_cast<const float*>(coef), static_cast<T*>(img_out),
      static_cast<uint8_t*>(ids_out), H, W, C);
  return cudaGetLastError();
}

}  // namespace

// img (B, H, W, C) with elements of elem_bytes (2 or 4) bytes, ids
// (B, H, W) uint8, coef (B, 10) float32, all contiguous; B <= 65535.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_warp(const void* img, const void* ids, const void* coef,
                         void* img_out, void* ids_out, int B, int H, int W,
                         int C, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 2)
    return (int)run<uint16_t>(img, ids, coef, img_out, ids_out, B, H, W, C, s);
  if (elem_bytes == 4)
    return (int)run<uint32_t>(img, ids, coef, img_out, ids_out, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
