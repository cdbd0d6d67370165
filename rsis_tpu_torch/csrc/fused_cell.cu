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
// with gate order i, f, o, g (the layouts and halo semantics are in
// cell_common.cuh, which holds the gate convolution shared with the
// backward kernel cell_bwd.cu).
//
// What bounds it on the card: at the decode shapes (4C <= 512,
// K = 9(Cx+C) <= 1728) the gate conv is about 1.8 GFLOP per image per
// cell against 1-21 MB of inputs and outputs, so on the tensor cores it is
// bound by device-memory bytes (S, x_pad, h/c in and out).
//
// Design against that bound: the 4C gates of a pixel and the im2col taps
// never reach device memory. One block owns one output row of one image
// (R rows on the tensor-core path), a tile of columns, and ALL 4C gate
// channels of those pixels, so the LSTM epilogue runs on the accumulators
// in registers. The halo of x_pad and h_prev for the tile (all Cx + C
// channels) is staged once in shared memory (coalesced along W, 8 loads in
// flight per thread); S, c_prev, h and c are read and written once.
// wgmma/TMA and a pipelined weight stage are later work.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::sigmoid_f;
using rsis::to_f;

// The LSTM update on the four gate sums of one (row, c, x).
template <typename T>
struct LstmForward {
  const T* __restrict__ c_prev;
  const T* __restrict__ s_term;
  T* __restrict__ h_out;
  T* __restrict__ c_out;
  int C, W;

  __device__ __forceinline__ void operator()(size_t row, int c, int x,
                                             float ai, float af, float ao,
                                             float ag) const {
    const T* s = s_term + (row * 4 * C + c) * W + x;
    const float ig = sigmoid_f(ai + to_f(s[0]));
    const float fg = sigmoid_f(af + to_f(s[(size_t)C * W]));
    const float og = sigmoid_f(ao + to_f(s[(size_t)2 * C * W]));
    const float gg = tanhf(ag + to_f(s[(size_t)3 * C * W]));
    const size_t o = (row * C + c) * W + x;
    const float c_new = fg * to_f(c_prev[o]) + ig * gg;
    h_out[o] = from_f<T>(og * tanhf(c_new));
    c_out[o] = from_f<T>(c_new);
  }
};

template <typename T>
cudaError_t run(const void* h_prev, const void* x_pad, const void* c_prev,
                const void* s_term, const void* wt, void* h_out, void* c_out,
                int B, int H, int W, int C, int Cx, cudaStream_t stream) {
  LstmForward<T> epi{static_cast<const T*>(c_prev),
                     static_cast<const T*>(s_term), static_cast<T*>(h_out),
                     static_cast<T*>(c_out), C, W};
  return rsis::launch_cell<T>(h_prev, x_pad, wt, B, H, W, C, Cx, stream, epi);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor in the same dtype).
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_fused_cell(const void* h_prev, const void* x_pad,
                               const void* c_prev, const void* s_term,
                               const void* wt, void* h_out, void* c_out,
                               int B, int H, int W, int C, int Cx, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(h_prev, x_pad, c_prev, s_term, wt, h_out, c_out, B,
                           H, W, C, Cx, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(h_prev, x_pad, c_prev, s_term, wt, h_out,
                                   c_out, B, H, W, C, Cx, s);
  return (int)cudaErrorInvalidValue;
}
