// ConvLSTM cell backward for Hopper (sm_90a): recompute the gates and emit
// the pre-activation gate cotangents and dc_prev.
//
// Replaces: rsis_tpu/ops/pallas_decode_vjp.py::_cell_backward_dgates_jit
// (kernel bodies _bwd_kernel and _bwd_kernel_dyfold). As there, the
// backward keeps nothing from the forward but its inputs: the gates are
// recomputed by the forward kernel's own gate convolution
// (cell_common.cuh, the same main loops in the same order), and only the
// epilogue differs. It reads dh and dc and applies, in fp32,
//   dc_tot = dc + dh * o * (1 - tanh(c)^2)
//   d_i = dc_tot * g * i(1 - i);   d_f = dc_tot * c_prev * f(1 - f)
//   d_o = dh * tanh(c) * o(1 - o); d_g = dc_tot * i * (1 - g^2)
//   dc_prev = dc_tot * f
// storing dg (B, H, 4C, W) and dc_prev (B, H, C, W) in the input dtype.
//
// What bounds it on the card: the same gate conv as the forward (about
// 1.8 GFLOP per image per cell on the tensor cores) against S, x_pad,
// h_prev, c_prev, dh and dc read once and dg (4C) and dc_prev written once:
// device-memory bytes, with dg the largest single tensor.
//
// Design: the tensor-core tile puts i, f, o and g of one (pixel, channel)
// in one lane, so the epilogue needs no shuffles; it stores the four gate
// cotangents where the forward stores h and c.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::sigmoid_f;
using rsis::to_f;

template <typename T>
struct LstmBackward {
  const T* __restrict__ c_prev;
  const T* __restrict__ s_term;
  const T* __restrict__ dh;
  const T* __restrict__ dc;
  T* __restrict__ dg;
  T* __restrict__ dc_prev;
  int C, W;

  __device__ __forceinline__ void operator()(size_t row, int c, int x,
                                             float ai, float af, float ao,
                                             float ag) const {
    const size_t cw = (size_t)C * W;
    const size_t gi = (row * 4 * C + c) * W + x;
    const float ig = sigmoid_f(ai + to_f(s_term[gi]));
    const float fg = sigmoid_f(af + to_f(s_term[gi + cw]));
    const float og = sigmoid_f(ao + to_f(s_term[gi + 2 * cw]));
    const float gg = tanhf(ag + to_f(s_term[gi + 3 * cw]));
    const size_t o = (row * C + c) * W + x;
    const float cp = to_f(c_prev[o]);
    const float c_new = fg * cp + ig * gg;
    const float tc = tanhf(c_new);
    const float dhv = to_f(dh[o]);
    const float dc_tot = to_f(dc[o]) + dhv * og * (1.0f - tc * tc);
    dg[gi] = from_f<T>(dc_tot * gg * ig * (1.0f - ig));
    dg[gi + cw] = from_f<T>(dc_tot * cp * fg * (1.0f - fg));
    dg[gi + 2 * cw] = from_f<T>(dhv * tc * og * (1.0f - og));
    dg[gi + 3 * cw] = from_f<T>(dc_tot * ig * (1.0f - gg * gg));
    dc_prev[o] = from_f<T>(dc_tot * fg);
  }
};

template <typename T>
cudaError_t run(const void* h_prev, const void* x_pad, const void* c_prev,
                const void* s_term, const void* wt, const void* dh,
                const void* dc, void* dg, void* dc_prev, int B, int H, int W,
                int C, int Cx, cudaStream_t stream) {
  LstmBackward<T> epi{static_cast<const T*>(c_prev),
                      static_cast<const T*>(s_term),
                      static_cast<const T*>(dh), static_cast<const T*>(dc),
                      static_cast<T*>(dg), static_cast<T*>(dc_prev), C, W};
  return rsis::launch_cell<T>(h_prev, x_pad, wt, B, H, W, C, Cx, stream, epi);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor in the same dtype).
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_cell_bwd(const void* h_prev, const void* x_pad,
                             const void* c_prev, const void* s_term,
                             const void* wt, const void* dh, const void* dc,
                             void* dg, void* dc_prev, int B, int H, int W,
                             int C, int Cx, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(h_prev, x_pad, c_prev, s_term, wt, dh, dc, dg,
                           dc_prev, B, H, W, C, Cx, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(h_prev, x_pad, c_prev, s_term, wt, dh, dc,
                                   dg, dc_prev, B, H, W, C, Cx, s);
  return (int)cudaErrorInvalidValue;
}
