// One ConvLSTM step on NCHW tensors for Hopper (sm_90a): the 3x3 gate
// convolution over concat(x, h_prev) with the bias and the LSTM update
// fused into its epilogue.
//
// Replaces: rsis_tpu/ops/pallas_clstm.py::fused_convlstm_step (kernel body
// _cell_kernel). The TPU kernel's body/halo split of a pre-padded input,
// its VMEM tile picker and its even-H requirement only fitted the work to
// the TPU's pipelined blocks; this kernel takes any H and W and reads the
// unpadded tensors with a zero SAME halo.
//
// Computes, for x (B, Cx, H, W), h_prev and c_prev (B, C, H, W), the gate
// weight in x's dtype (packed for the staged loop, OHWI for the FMA loop)
// and an fp32 bias (4C,):
//   gates = conv3x3_same(concat(x, h_prev), weight) + bias    (4C, fp32)
//   c = sig(f) * c_prev + sig(i) * tanh(g);  h = sig(o) * tanh(c)
// with gate order i, f, o, g, c_prev read as fp32 and h, c stored in x's
// dtype: the JAX kernel's contract. The concat is never built: the
// K-chunks walk the x channels and then the h channels.
//
// What bounds it on the card: at the mul decode's cells (4C <= 512,
// K = 9(Cx+C) <= 2304) the gate conv is 2 * 4C * K FLOP per pixel against
// (Cx + 2C) * 2 bytes in and 2C * 2 out in bf16: from about 120 FLOP per
// byte at cell 4 to 1.5 k at cell 0, against the H100's 295 in bf16, so
// the tensor cores' rate bounds cells 0-2 and device memory cells 3-4.
//
// Design (bf16 with C, Cx and W multiples of 8: every cell of the mul
// decode): the staged loop of cell_common.cuh that the decode cell K1 and
// its backward K4 run (see fused_cell.cu), with NchwLayout: a block owns
// a unit of output pixels and a tile of hidden channels with all four of
// their gates, so the LSTM update runs on the accumulators and the gates
// never reach device memory; the packed weight (pack_cell_weights' order,
// written by the wrapper in the cast the cell needs anyway) streams once
// per unit through shared memory in K-chunks of nine taps x cc channels
// of x or of h, beside the chunk's halo; x's and h_prev's NCHW rows
// arrive by 16-byte cp.async copies with a zero SAME halo (W-contiguous
// like K1's h_prev rows) and are transposed once to [pixel][channel];
// c_prev is the epilogue's one staged plane, h and c leave through two
// planes in 16-byte stores, and the tile's fp32 biases wait in shared
// memory. Where the units leave SMs idle, the chunks are split into
// fixed-order fp32 partials summed by a second launch (no atomics). The
// plan comes from cell_plan(..., kind="step") in ops/fused_cell.py.
// Everything else (fp32, other widths) runs the FMA loop of
// cell_common.cuh on the OHWI weight.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::sigmoid_f;
using rsis::to_f;

// The LSTM update on the pre-activation gates (bias included).
__device__ __forceinline__ void lstm_update(float ai, float af, float ao,
                                            float ag, float cp, float& h,
                                            float& c) {
  const float ig = sigmoid_f(ai);
  const float fg = sigmoid_f(af);
  const float og = sigmoid_f(ao);
  const float gg = tanhf(ag);
  c = fg * cp + ig * gg;
  h = og * tanhf(c);
}

// The LSTM update with the fp32 bias: on the four gate sums of one (row =
// b * H + y, c, x) of the NCHW state (the FMA loop, the parts' sum), or on
// the staged plane c_prev of the tensor-core loop (the kernel adds the
// bias), h written into c_prev's plane and c into the second.
template <typename T>
struct LstmStep {
  const T* __restrict__ c_prev;
  const float* __restrict__ bias;
  T* __restrict__ h_out;
  T* __restrict__ c_out;
  int C, H, W;

  __device__ __forceinline__ void operator()(size_t row, int c, int x,
                                             float ai, float af, float ao,
                                             float ag) const {
    const size_t o = nchw_row(row, c) + x;
    float h, cn;
    lstm_update(ai + bias[c], af + bias[C + c], ao + bias[2 * C + c],
                ag + bias[3 * C + c], to_f(c_prev[o]), h, cn);
    h_out[o] = from_f<T>(h);
    c_out[o] = from_f<T>(cn);
  }

  static constexpr int kIn = 1;
  static constexpr int kOut = 2;
  static constexpr bool kBias = true;
  static __device__ __forceinline__ int out_plane(int k) { return k; }
  // the element offset of row (b, c, y) of a (B, C, H, W) tensor
  __device__ __forceinline__ size_t nchw_row(size_t row, int c) const {
    return ((row / H * C + c) * H + row % H) * W;
  }
  __device__ __forceinline__ const T* in_row(int, size_t row, int c) const {
    return c_prev + nchw_row(row, c);
  }
  __device__ __forceinline__ T* out_row(int k, size_t row, int c) const {
    return (k ? c_out : h_out) + nchw_row(row, c);
  }
  __device__ __forceinline__ void tile(const float (&g)[4],
                                       const float (&v)[kIn],
                                       float (&o)[kOut]) const {
    lstm_update(g[0], g[1], g[2], g[3], v[0], o[0], o[1]);
  }
};

template <typename T>
cudaError_t run(const void* x, const void* h_prev, const void* c_prev,
                const void* weight, const void* bias, void* h_out,
                void* c_out, float* ws, long long ws_floats, int B, int H,
                int W, int C, int Cx, int mma, int wm, int wj, int per_sm,
                const rsis::CellPlan& p, cudaStream_t stream) {
  LstmStep<T> epi{static_cast<const T*>(c_prev),
                  static_cast<const float*>(bias), static_cast<T*>(h_out),
                  static_cast<T*>(c_out), C, H, W};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma)
      return rsis::launch_cell_staged<rsis::NchwLayout>(
          h_prev, x, weight, ws, ws_floats, B, H, W, C, Cx, wm, wj, per_sm,
          p, stream, epi);
  }
  if (mma) return cudaErrorInvalidValue;
  return rsis::launch_cell_fma_loop<T, rsis::NchwLayout>(
      h_prev, x, weight, B, H, W, C, Cx, stream, epi);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h_prev, c_prev, weight, h_out and
// c_out in that dtype; bias always float32). The plan (cell_plan(...,
// kind="step")) as rsis_fused_cell takes it: mma = 0 runs the FMA loop on
// the OHWI weight (4C, 3, 3, Cx+C), mma = 1 the staged loop on the packed
// weight (4C, 9(Cx+C)) of pack_cell_weights (bfloat16, C, Cx and W
// multiples of 8; x null where Cx = 0). Returns the first failing
// launch's cudaError_t (0 on success); cudaErrorInvalidValue for a plan
// or operands that do not fit.
extern "C" int rsis_clstm_step(const void* x, const void* h_prev,
                               const void* c_prev, const void* weight,
                               const void* bias, void* h_out, void* c_out,
                               void* ws, long long ws_floats, int B, int H,
                               int W, int C, int Cx, int dtype, int mma,
                               int wm, int wj, int warps_m, int warps_n,
                               int rows, int tw, int cc, int stages,
                               int splits, int groups, int per_sm,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rsis::CellPlan p{warps_m, warps_n, rows, tw, cc, stages, splits,
                         groups};
  float* wsp = static_cast<float*>(ws);
  if (dtype == 0)
    return (int)run<float>(x, h_prev, c_prev, weight, bias, h_out, c_out,
                           wsp, ws_floats, B, H, W, C, Cx, mma, wm, wj,
                           per_sm, p, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, h_prev, c_prev, weight, bias, h_out,
                                   c_out, wsp, ws_floats, B, H, W, C, Cx, mma,
                                   wm, wj, per_sm, p, s);
  return (int)cudaErrorInvalidValue;
}
