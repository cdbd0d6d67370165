// Fused ConvLSTM decode cell for Hopper (sm_90a): implicit-GEMM gate
// convolution with the LSTM update fused into its epilogue (K1).
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
// What bounds it on the card: at the decode's cells (512x1024 input,
// hidden 128, B = 32) the gate conv is 2 * 4C * 9(Cx+C) FLOP a pixel,
// 19 GFLOP at cell 0 and 58 at cells 1-4, against S (4C), x_pad, h_prev,
// c_prev read once and h, c written once: the tensor cores bound cells
// 0-2 (0.020-0.059 ms) and device memory cells 3-4 (0.10 and 0.20 ms).
//
// Design (bf16 with C and Cx multiples of 8: every cell of the decode;
// the staged loop of cell_common.cuh, shared with K4; W not a multiple of
// 8, as at the CVPPP recipe's 400x400 input, takes its edge variant):
//   1. A block owns a unit of rows x tw output pixels (128-512) and a
//      tile of Ct hidden channels with all four of their gates, so the
//      LSTM update runs on the accumulators with no shuffles; it walks
//      several units in turn where the cell has more units than the card
//      has SMs.
//   2. The weight streams once per unit, not once per 16 pixels, through
//      shared memory in K-chunks of all nine taps x cc channels of x or of
//      h (B by ldmatrix), beside the chunk's halo: a ring of 2-3 chunks
//      filled by 16-byte cp.async copies of x_pad's rows (from their
//      16-byte boundary) and h_prev's (zero SAME halo), transposed once to
//      [pixel][channel] so a tap is a whole-row offset for A's ldmatrix.
//      Cell 4 (C = 8) runs 8-channel chunks, two taps a k16 step of mma.
//   3. S and c_prev are staged per unit as W-contiguous rows by 16-byte
//      cp.async copies issued with the unit's first chunk and tracked by
//      an mbarrier, read in the accumulators' layout by ldmatrix.trans; h
//      and c go back by stmatrix.trans into the same rows and leave in
//      16-byte stores.
//   4. Where the units leave most SMs idle (cell 0 at small batches), the
//      chunks are split into parts writing fp32 partial gate sums, and a
//      second launch sums them in part order and runs the update: no
//      atomics, the same bits on every launch.
// The plan comes from the host (cell_plan in ops/fused_cell.py;
// chip_k5_step.py --cell-sweep times every alternative). Everything else
// (fp32, other channel widths) runs the FMA loop of cell_common.cuh.

#include "cell_common.cuh"

namespace {

using rsis::from_f;
using rsis::sigmoid_f;
using rsis::to_f;

// The LSTM update on the pre-activation gates (S included).
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

// The forward's epilogue: on one (row, c, x) of device memory (the FMA
// loop, the parts' sum), or on the staged planes S_i, S_f, S_o, S_g,
// c_prev of the tensor-core loop, h written into S_i's plane and c into
// c_prev's.
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
    const size_t cw = (size_t)C * W;
    const size_t o = (row * C + c) * W + x;
    float h, cn;
    lstm_update(ai + to_f(s[0]), af + to_f(s[cw]), ao + to_f(s[2 * cw]),
                ag + to_f(s[3 * cw]), to_f(c_prev[o]), h, cn);
    h_out[o] = from_f<T>(h);
    c_out[o] = from_f<T>(cn);
  }

  static constexpr int kIn = 5;
  static constexpr int kOut = 2;
  static __device__ __forceinline__ int out_plane(int k) { return k ? 4 : 0; }
  __device__ __forceinline__ const T* in_row(int pl, size_t row,
                                             int c) const {
    return pl < 4 ? s_term + (row * 4 * C + pl * C + c) * W
                  : c_prev + (row * C + c) * W;
  }
  __device__ __forceinline__ T* out_row(int k, size_t row, int c) const {
    return (k ? c_out : h_out) + (row * C + c) * W;
  }
  __device__ __forceinline__ void tile(const float (&g)[4],
                                       const float (&v)[kIn],
                                       float (&o)[kOut]) const {
    lstm_update(g[0] + v[0], g[1] + v[1], g[2] + v[2], g[3] + v[3], v[4],
                o[0], o[1]);
  }
};

template <typename T>
cudaError_t run(const void* h_prev, const void* x_pad, const void* c_prev,
                const void* s_term, const void* wt, void* h_out, void* c_out,
                float* ws, long long ws_floats, int B, int H, int W, int C,
                int Cx, int mma, int wm, int wj, int per_sm,
                const rsis::CellPlan& p, cudaStream_t stream) {
  LstmForward<T> epi{static_cast<const T*>(c_prev),
                     static_cast<const T*>(s_term), static_cast<T*>(h_out),
                     static_cast<T*>(c_out), C, W};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma)
      return rsis::launch_cell_staged<rsis::RowMajorLayout, true>(
          h_prev, x_pad, wt, ws, ws_floats, B, H, W, C, Cx, wm, wj, per_sm, p,
          stream, epi);
  }
  if (mma) return cudaErrorInvalidValue;
  return rsis::launch_cell_fma_loop<T, rsis::RowMajorLayout>(
      h_prev, x_pad, wt, B, H, W, C, Cx, stream, epi);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor in the same dtype). The
// plan (cell_plan): mma = 0 runs the FMA loop (the other fields unused);
// mma = 1 the staged tensor-core loop (bfloat16, C and Cx multiples of 8;
// W any, its edge variant where W is not a multiple of 8) with warp tiles of wm m-tiles x wj channel blocks, warps_m x warps_n
// warps, units of rows x tw pixels, K-chunks of cc channels in a ring of
// `stages`, `splits` parts of the chunks (ws then holds at least splits *
// B * H * 4C * W floats), `groups` blocks of units and per_sm blocks an
// SM (2 only with wm * wj <= 4). Returns the first
// failing launch's cudaError_t (0 on success); cudaErrorInvalidValue for a
// plan or operands that do not fit.
extern "C" int rsis_fused_cell(const void* h_prev, const void* x_pad,
                               const void* c_prev, const void* s_term,
                               const void* wt, void* h_out, void* c_out,
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
    return (int)run<float>(h_prev, x_pad, c_prev, s_term, wt, h_out, c_out,
                           wsp, ws_floats, B, H, W, C, Cx, mma, wm, wj,
                           per_sm, p, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(h_prev, x_pad, c_prev, s_term, wt, h_out,
                                   c_out, wsp, ws_floats, B, H, W, C, Cx, mma,
                                   wm, wj, per_sm, p, s);
  return (int)cudaErrorInvalidValue;
}
