// ConvLSTM cell backward for Hopper (sm_90a): recompute the gates and emit
// the pre-activation gate cotangents and dc_prev (K4).
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
// What bounds it on the card: the same gate conv as the forward (at the
// train step's cells, 256x512 input at B = 32: 4.8 GFLOP at cell 0 and
// 14.5 at cells 1-4) against S, x_pad, h_prev, c_prev, dh and dc read once
// and dg (4C) and dc_prev written once: the tensor cores bound cells 0-1,
// device-memory bytes cells 2-4, dg the largest single tensor.
//
// Design: the forward's staged loop (cell_common.cuh; see fused_cell.cu):
// a unit of pixels x a tile of hidden channels with their four gates a
// block, the weight streamed once per unit through shared memory in
// K-chunks beside the chunk's transposed halo, a cp.async ring, mma.sync
// with fp32 accumulators. The epilogue stages seven planes per unit (S's
// four gates, c_prev, dh, dc) as W-contiguous rows, reads them in the
// accumulators' layout by ldmatrix.trans, and writes dg's four gates and
// dc_prev back into the planes of S and c_prev, which leave in 16-byte
// stores along W. The plan (cell_plan(..., backward=True)) sizes the
// tiles for the seven planes.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::sigmoid_f;
using rsis::to_f;

// The gate cotangents and dc_prev from the pre-activation gates (S
// included), c_prev, dh and dc: d[0..3] = dg's i, f, o, g, d[4] = dc_prev.
__device__ __forceinline__ void lstm_backward(float ai, float af, float ao,
                                              float ag, float cp, float dhv,
                                              float dcv, float (&d)[5]) {
  const float ig = sigmoid_f(ai);
  const float fg = sigmoid_f(af);
  const float og = sigmoid_f(ao);
  const float gg = tanhf(ag);
  const float c_new = fg * cp + ig * gg;
  const float tc = tanhf(c_new);
  const float dc_tot = dcv + dhv * og * (1.0f - tc * tc);
  d[0] = dc_tot * gg * ig * (1.0f - ig);
  d[1] = dc_tot * cp * fg * (1.0f - fg);
  d[2] = dhv * tc * og * (1.0f - og);
  d[3] = dc_tot * ig * (1.0f - gg * gg);
  d[4] = dc_tot * fg;
}

// The backward's epilogue: on one (row, c, x) of device memory (the FMA
// loop, the parts' sum), or on the staged planes S_i .. S_g, c_prev, dh,
// dc of the tensor-core loop, dg's gates written into S's planes and
// dc_prev into c_prev's.
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
    const size_t o = (row * C + c) * W + x;
    float d[5];
    lstm_backward(ai + to_f(s_term[gi]), af + to_f(s_term[gi + cw]),
                  ao + to_f(s_term[gi + 2 * cw]),
                  ag + to_f(s_term[gi + 3 * cw]), to_f(c_prev[o]),
                  to_f(dh[o]), to_f(dc[o]), d);
#pragma unroll
    for (int q = 0; q < 4; ++q) dg[gi + q * cw] = from_f<T>(d[q]);
    dc_prev[o] = from_f<T>(d[4]);
  }

  static constexpr int kIn = 7;
  static constexpr int kOut = 5;
  static __device__ __forceinline__ int out_plane(int k) {
    return k < 4 ? k : 4;
  }
  __device__ __forceinline__ const T* in_row(int pl, size_t row,
                                             int c) const {
    if (pl < 4) return s_term + (row * 4 * C + pl * C + c) * W;
    return (pl == 4 ? c_prev : pl == 5 ? dh : dc) + (row * C + c) * W;
  }
  __device__ __forceinline__ T* out_row(int k, size_t row, int c) const {
    return k < 4 ? dg + (row * 4 * C + k * C + c) * W
                 : dc_prev + (row * C + c) * W;
  }
  __device__ __forceinline__ void tile(const float (&g)[4],
                                       const float (&v)[kIn],
                                       float (&o)[kOut]) const {
    lstm_backward(g[0] + v[0], g[1] + v[1], g[2] + v[2], g[3] + v[3], v[4],
                  v[5], v[6], o);
  }
};

template <typename T>
cudaError_t run(const void* h_prev, const void* x_pad, const void* c_prev,
                const void* s_term, const void* wt, const void* dh,
                const void* dc, void* dg, void* dc_prev, float* ws,
                long long ws_floats, int B, int H, int W, int C, int Cx,
                int mma, int wm, int wj, int per_sm,
                const rsis::CellPlan& p, cudaStream_t stream) {
  LstmBackward<T> epi{static_cast<const T*>(c_prev),
                      static_cast<const T*>(s_term),
                      static_cast<const T*>(dh), static_cast<const T*>(dc),
                      static_cast<T*>(dg), static_cast<T*>(dc_prev), C, W};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma)
      return rsis::launch_cell_staged(h_prev, x_pad, wt, ws, ws_floats, B, H,
                                      W, C, Cx, wm, wj, per_sm, p, stream,
                                      epi);
  }
  if (mma) return cudaErrorInvalidValue;
  return rsis::launch_cell_fma_loop<T, rsis::RowMajorLayout>(
      h_prev, x_pad, wt, B, H, W, C, Cx, stream, epi);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor in the same dtype). The
// plan as for rsis_fused_cell (cell_plan(..., backward=True)). Returns
// the first failing launch's cudaError_t (0 on success).
extern "C" int rsis_cell_bwd(const void* h_prev, const void* x_pad,
                             const void* c_prev, const void* s_term,
                             const void* wt, const void* dh, const void* dc,
                             void* dg, void* dc_prev, void* ws,
                             long long ws_floats, int B, int H, int W, int C,
                             int Cx, int dtype, int mma, int wm, int wj,
                             int warps_m, int warps_n, int rows, int tw,
                             int cc, int stages, int splits, int groups,
                             int per_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rsis::CellPlan p{warps_m, warps_n, rows, tw, cc, stages, splits,
                         groups};
  float* wsp = static_cast<float*>(ws);
  if (dtype == 0)
    return (int)run<float>(h_prev, x_pad, c_prev, s_term, wt, dh, dc, dg,
                           dc_prev, wsp, ws_floats, B, H, W, C, Cx, mma, wm,
                           wj, per_sm, p, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(h_prev, x_pad, c_prev, s_term, wt, dh, dc,
                                   dg, dc_prev, wsp, ws_floats, B, H, W, C,
                                   Cx, mma, wm, wj, per_sm, p, s);
  return (int)cudaErrorInvalidValue;
}
