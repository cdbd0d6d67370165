// Batched exact rectangular linear assignment for Hopper (sm_90a).
//
// Replaces: rsis_tpu/ops/pallas_matching.py::solve_lap_batch (kernel body
// _lap_kernel). Each (nr, nc) problem, nr <= nc <= 128 (rows = the T
// predictions, columns = the N ground-truth slots), is solved by shortest
// augmenting paths with dual potentials (Crouse 2016, the formulation of
// scipy.optimize.linear_sum_assignment): one Dijkstra over the columns
// per row, then the dual update and the augmentation along the
// predecessor chain. The output is row4col: the 0-indexed row assigned to
// each column, -1 for the nc - nr unassigned columns. The column choice
// breaks ties of the reduced cost toward an unassigned column, then
// toward the lowest index, as the TPU kernel does; the arithmetic is the
// same fp32 sequence as the plain version in ops/lap.py.
//
// What bounds it on the card: neither bytes nor operations (a (32, 20, 20)
// batch is 51 KB and a few hundred thousand flops) but the latency of the
// sequential Dijkstra steps: each step needs a minimum over the columns
// before the next can start.
//
// Design against that latency: one warp per problem, no block-wide
// barrier. The columns are spread over the lanes (column j on lane j % 32,
// up to 4 per lane) and the minimum comes from 5 warp shuffles; the duals,
// row4col, col4row, the predecessors and the scanned marks live in shared
// memory with direct indexing, read and written between __syncwarp()s.
// The whole batch is one launch and the result stays on the device.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarps = 4;  // problems per block
constexpr float kInf = 1e9f;

struct WarpState {
  float u[kMaxN];     // row duals
  float v[kMaxN];     // column duals
  float spc[kMaxN];   // shortest path cost to each column
  int r4c[kMaxN];     // row assigned to each column, -1 = free
  int c4r[kMaxN];     // column assigned to each row, -1 = free
  int pred[kMaxN];    // predecessor row of each column
  int sc[kMaxN];      // column scanned in this Dijkstra
  int sr[kMaxN];      // row scanned in this Dijkstra
};

// (value, assigned, column) lexicographic minimum
__device__ __forceinline__ bool better(float v, int a, int j, float v2, int a2,
                                       int j2) {
  if (v != v2) return v < v2;
  if (a != a2) return a < a2;
  return j < j2;
}

__global__ void __launch_bounds__(kWarps * 32)
lap_kernel(const float* __restrict__ costs, int* __restrict__ row4col, int B,
           int nr, int nc) {
  __shared__ WarpState states[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int prob = blockIdx.x * kWarps + warp;
  if (prob >= B) return;  // whole warps leave together
  WarpState& s = states[warp];
  const float* cost = costs + (size_t)prob * nr * nc;

  for (int j = lane; j < kMaxN; j += 32) {
    s.u[j] = 0.0f;
    s.v[j] = 0.0f;
    s.r4c[j] = -1;
    s.c4r[j] = -1;
  }
  __syncwarp();

  for (int cur_row = 0; cur_row < nr; ++cur_row) {
    for (int j = lane; j < kMaxN; j += 32) {
      s.spc[j] = kInf;
      s.pred[j] = 0;
      s.sc[j] = j >= nc;  // columns past nc are never chosen
      s.sr[j] = 0;
    }
    __syncwarp();

    int sink = -1;
    int icur = cur_row;
    float min_val = 0.0f;
    while (sink == -1) {  // uniform across the warp
      const float ui = s.u[icur];
      const float* crow = cost + (size_t)icur * nc;
      float bv = kInf;
      int ba = 1, bj = kMaxN;
      for (int j = lane; j < nc; j += 32) {
        if (s.sc[j]) continue;
        const float red = min_val + crow[j] - ui - s.v[j];
        if (red < s.spc[j]) {
          s.spc[j] = red;
          s.pred[j] = icur;
        }
        const int a = s.r4c[j] >= 0;
        if (better(s.spc[j], a, j, bv, ba, bj)) {
          bv = s.spc[j];
          ba = a;
          bj = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oa = __shfl_xor_sync(0xffffffffu, ba, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (better(ov, oa, oj, bv, ba, bj)) {
          bv = ov;
          ba = oa;
          bj = oj;
        }
      }
      const int rj = s.r4c[bj];
      __syncwarp();
      if (lane == 0) {
        s.sr[icur] = 1;
        s.sc[bj] = 1;
      }
      __syncwarp();
      min_val = bv;
      if (rj < 0)
        sink = bj;
      else
        icur = rj;
    }

    // dual update: the rows and columns this Dijkstra scanned
    for (int i = lane; i < nr; i += 32) {
      if (i == cur_row)
        s.u[i] = s.u[i] + min_val;
      else if (s.sr[i])
        s.u[i] = s.u[i] + (min_val - s.spc[s.c4r[i]]);
    }
    for (int j = lane; j < nc; j += 32)
      if (s.sc[j] && s.spc[j] < kInf * 0.5f)
        s.v[j] = s.v[j] - (min_val - s.spc[j]);
    __syncwarp();

    // augment along the predecessor chain
    if (lane == 0) {
      int j = sink;
      while (j >= 0) {
        const int ipred = s.pred[j];
        const int jnext = s.c4r[ipred];
        s.r4c[j] = ipred;
        s.c4r[ipred] = j;
        j = ipred == cur_row ? -1 : jnext;
      }
    }
    __syncwarp();
  }
  for (int j = lane; j < nc; j += 32) row4col[(size_t)prob * nc + j] = s.r4c[j];
}

}  // namespace

// costs (B, nr, nc) float32, nr <= nc <= 128 -> row4col (B, nc) int32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_lap(const void* costs, void* row4col, int B, int nr,
                        int nc, void* stream) {
  if (B <= 0 || nr <= 0 || nr > nc || nc > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kWarps - 1) / kWarps;
  lap_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<int*>(row4col), B, nr, nc);
  return (int)cudaGetLastError();
}
