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
// weight as OHWI (4C, 3, 3, Cx+C) in x's dtype and an fp32 bias (4C,):
//   gates = conv3x3_same(concat(x, h_prev), weight) + bias    (4C, fp32)
//   c = sig(f) * c_prev + sig(i) * tanh(g);  h = sig(o) * tanh(c)
// with gate order i, f, o, g, c_prev read as fp32 and h, c stored in x's
// dtype: the JAX kernel's contract. The concat is never built: the halo
// stage reads the x channels and then the h channels of each pixel.
//
// What bounds it on the card: at the mul decode's cells (4C <= 512,
// K = 9(Cx+C) <= 2304) the gate conv is 2 * 4C * K FLOP per pixel against
// (Cx + 2C) * 2 bytes in and 2C * 2 out in bf16: from about 120 FLOP per
// byte at cell 4 to 1.5 k at cell 0, against the H100's 295 in bf16, so
// the tensor cores' rate bounds cells 0-2 and device memory cells 3-4.
//
// Design: the same main loops as the decode cell K1 (cell_common.cuh with
// NchwLayout): one block owns a tile of output pixels and all 4C gate
// channels, so the LSTM update runs on the accumulators in registers and
// the gates never reach device memory; the halo of all Cx + C channels is
// staged once in shared memory; the bf16 path is mma.sync m16n8k16 with
// fp32 accumulation (C and Cx multiples of 8), the rest an fp32 FMA loop.
// The weight comes as OHWI, so the 8 channels of a k-group are adjacent
// and a B pair is one 32-bit load, as in K1 (read as OIHW, with pairs 9
// elements apart, the kernel took 2.5x K1's time on the same product);
// the wrapper writes that copy in the cast the cell needs anyway.
// wgmma/TMA and a weight staged in shared memory are later work.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::sigmoid_f;
using rsis::to_f;

// The LSTM update with the fp32 bias on the four gate sums of one
// (row = b * H + y, c, x), NCHW state.
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
    const size_t b = row / H;
    const size_t y = row % H;
    const size_t o = ((b * C + c) * H + y) * W + x;
    const float ig = sigmoid_f(ai + bias[c]);
    const float fg = sigmoid_f(af + bias[C + c]);
    const float og = sigmoid_f(ao + bias[2 * C + c]);
    const float gg = tanhf(ag + bias[3 * C + c]);
    const float c_new = fg * to_f(c_prev[o]) + ig * gg;
    h_out[o] = from_f<T>(og * tanhf(c_new));
    c_out[o] = from_f<T>(c_new);
  }
};

template <typename T>
cudaError_t run(const void* x, const void* h_prev, const void* c_prev,
                const void* weight, const void* bias, void* h_out,
                void* c_out, int B, int H, int W, int C, int Cx,
                cudaStream_t stream) {
  LstmStep<T> epi{static_cast<const T*>(c_prev),
                  static_cast<const float*>(bias), static_cast<T*>(h_out),
                  static_cast<T*>(c_out), C, H, W};
  return rsis::launch_cell<T, rsis::NchwLayout>(h_prev, x, weight, B, H, W,
                                                C, Cx, stream, epi);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h_prev, c_prev, weight, h_out and
// c_out in that dtype; bias always float32). Returns the launch's
// cudaError_t (0 on success).
extern "C" int rsis_clstm_step(const void* x, const void* h_prev,
                               const void* c_prev, const void* weight,
                               const void* bias, void* h_out, void* c_out,
                               int B, int H, int W, int C, int Cx, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(x, h_prev, c_prev, weight, bias, h_out, c_out, B,
                           H, W, C, Cx, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, h_prev, c_prev, weight, bias, h_out,
                                   c_out, B, H, W, C, Cx, s);
  return (int)cudaErrorInvalidValue;
}
