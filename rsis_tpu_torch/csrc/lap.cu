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
// same fp32 sequence as the plain version in ops/lap.py (each sum rounded
// on its own, in its order), so row4col equals the plain version's.
//
// What bounds it on the card: neither bytes nor operations (a (32, 20, 20)
// batch is 51 KB and a few hundred thousand flops) but the chain of
// dependent Dijkstra steps: a step's row comes from the previous step's
// minimum over the columns. Its figure of merit is the time of one step of
// the batch's longest problem (ns a step).
//
// Design against that chain: one warp a problem, and between two steps
// nothing but the warp's registers, one shared-memory load and warp
// collectives.
//   1. A block is the problem's one warp. Its nr x nc costs are staged
//      once into shared memory (dynamic, nr * nc * 4 bytes) by 4-byte
//      cp.async copies, all in flight together and coalesced along
//      whichever of the caller's row and column strides is 1 (the matcher
//      passes the transposed view of its (B, N, M) costs, so no copy
//      precedes the launch).
//   2. Column j lives on lane j % 32 in register slot j / 32 (S =
//      ceil(nc / 32) slots, a template argument): its dual v, shortest path
//      cost spc, predecessor, assigned row and scanned bit. Row i's dual u,
//      assigned column and scanned bit live on lane i % 32 the same way. A
//      step reads u[icur] by one shuffle and its cost row from shared
//      memory; a reset touches only the lane's own slots.
//   3. The column choice is two warp reductions (redux.sync): the minimum
//      of an order-preserving uint32 key of spc (-0.0 keyed as +0.0, as
//      the plain version's == counts them equal; scanned and padded
//      columns the largest key), then, among the lanes that hold that key
//      (each lane first takes the best of its own slots), the minimum of
//      assigned << 14 | column << 7 | row: an unassigned column first, then
//      the lowest index, and the chosen column's row comes with it.
//   4. The dual update reads spc at each scanned row's column by S
//      shuffles; the augmentation walks the chain with two shuffles a hop
//      (pred from the column's lane, c4r from the row's lane), and the
//      lanes that own a column or a row write it.
// Each problem's order of operations is fixed, so launches are
// bit-identical. Costs are finite with reduced costs below 1e9 (the plain
// version's infinity).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;
constexpr float kInf = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// float -> uint32 whose unsigned order is the float order (finite values);
// adding +0.0 first maps -0.0 to +0.0
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a[s] for a warp-uniform slot s, without indexing registers dynamically
template <int S, typename T>
__device__ __forceinline__ T pick(const T (&a)[S], int s) {
  T x = a[0];
#pragma unroll
  for (int k = 1; k < S; ++k)
    if (s == k) x = a[k];
  return x;
}

template <int S, typename T>
__device__ __forceinline__ void put(T (&a)[S], int s, T x) {
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (s == k) a[k] = x;
}

template <int S>
__global__ void __launch_bounds__(32)
lap_kernel(const float* __restrict__ costs, int* __restrict__ row4col,
           int nr, int nc, long long sb, long long sr, long long sc) {
  extern __shared__ float cost[];
  const int lane = threadIdx.x;
  const int prob = blockIdx.x;

  // 1. stage the costs, cost[i * nc + j], in the order they lie in memory
  const float* src = costs + (size_t)prob * sb;
  const int n = nr * nc;
  if (sr == 1 && sc != 1) {
    for (int e = lane; e < n; e += 32) {
      const int j = e / nr, i = e - j * nr;
      cp_async4(cost + i * nc + j, src + i + j * sc);
    }
  } else {
    for (int e = lane; e < n; e += 32) {
      const int i = e / nc, j = e - i * nc;
      cp_async4(cost + e, src + i * sr + j * sc);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // 2. column state (slot s: column lane + 32 s) and row state (row lane +
  // 32 s) in registers
  float u[S], v[S], spc[S];
  int c4r[S], r4c[S], pred[S];
  unsigned live = 0;  // bit s: the slot's column exists
#pragma unroll
  for (int s = 0; s < S; ++s) {
    u[s] = 0.0f;
    v[s] = 0.0f;
    c4r[s] = -1;
    r4c[s] = -1;
    if (lane + 32 * s < nc) live |= 1u << s;
  }

  for (int cur_row = 0; cur_row < nr; ++cur_row) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      spc[s] = kInf;
      pred[s] = 0;
    }
    unsigned scanned = 0, rows_scanned = 0;
    int icur = cur_row, sink = -1;
    float min_val = 0.0f;
    while (true) {  // uniform across the warp
      const float ui = __shfl_sync(kFull, pick(u, icur >> 5), icur & 31);
      if (lane == (icur & 31)) rows_scanned |= 1u << (icur >> 5);
      const float* crow = cost + icur * nc;
      unsigned best_key = 0xffffffffu, best_tag = 0xffffffffu;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (!(((live & ~scanned) >> s) & 1u)) continue;
        const int j = lane + 32 * s;
        const float red = __fsub_rn(
            __fsub_rn(__fadd_rn(min_val, crow[j]), ui), v[s]);
        if (red < spc[s]) {
          spc[s] = red;
          pred[s] = icur;
        }
        // 3. the lane's best slot: (key, assigned, column)
        const unsigned key = order_key(spc[s]);
        const unsigned tag = r4c[s] >= 0
            ? (1u << 14) | (unsigned)(j << 7) | (unsigned)r4c[s]
            : (unsigned)(j << 7);
        if (key < best_key || (key == best_key && tag < best_tag)) {
          best_key = key;
          best_tag = tag;
        }
      }
      const unsigned kmin = __reduce_min_sync(kFull, best_key);
      const unsigned tmin = __reduce_min_sync(
          kFull, best_key == kmin ? best_tag : 0xffffffffu);
      const int j = (tmin >> 7) & 127;
      if (lane == (j & 31)) scanned |= 1u << (j >> 5);
      min_val = key_value(kmin);
      if (!(tmin >> 14)) {
        sink = j;
        break;
      }
      icur = tmin & 127;
    }

    // 4. dual update: the rows and columns this Dijkstra scanned
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (32 * s >= nr) break;  // uniform: no row in this slot
      const int col = c4r[s];
      float at = 0.0f;  // spc[c4r[i]]
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float x = __shfl_sync(kFull, spc[t], col & 31);
        if ((col >> 5) == t) at = x;
      }
      if (lane + 32 * s == cur_row)
        u[s] = __fadd_rn(u[s], min_val);
      else if ((rows_scanned >> s) & 1u)
        u[s] = __fadd_rn(u[s], __fsub_rn(min_val, at));
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (((scanned >> s) & 1u) && spc[s] < kInf * 0.5f)
        v[s] = __fsub_rn(v[s], __fsub_rn(min_val, spc[s]));

    // augment along the predecessor chain
    int j = sink;
    while (true) {  // uniform across the warp
      const int ipred = __shfl_sync(kFull, pick(pred, j >> 5), j & 31);
      const int jnext =
          __shfl_sync(kFull, pick(c4r, ipred >> 5), ipred & 31);
      if (lane == (j & 31)) put(r4c, j >> 5, ipred);
      if (lane == (ipred & 31)) put(c4r, ipred >> 5, j);
      if (ipred == cur_row) break;
      j = jnext;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if ((live >> s) & 1u)
      row4col[(size_t)prob * nc + lane + 32 * s] = r4c[s];
}

template <int S>
cudaError_t run(const float* costs, int* row4col, int B, int nr, int nc,
                long long sb, long long sr, long long sc,
                cudaStream_t stream) {
  const size_t smem = (size_t)nr * nc * sizeof(float);  // 64 KB at most
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  lap_kernel<S><<<B, 32, smem, stream>>>(costs, row4col, nr, nc, sb, sr, sc);
  return cudaGetLastError();
}

}  // namespace

// costs (B, nr, nc) float32 at element strides (sb, sr, sc), sr == 1 or
// sc == 1, nr <= nc <= 128 -> row4col (B, nc) int32, contiguous; B blocks
// of one warp. Returns the launch's cudaError_t (0 on success).
extern "C" int rsis_lap(const void* costs, void* row4col, int B, int nr,
                        int nc, long long sb, long long sr, long long sc,
                        void* stream) {
  if (B <= 0 || nr <= 0 || nr > nc || nc > kMaxN || sb < 0 || sr < 0 ||
      sc < 0 || (sr != 1 && sc != 1))
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(costs);
  int* out = static_cast<int*>(row4col);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nc + 31) / 32) {
    case 1: return (int)run<1>(c, out, B, nr, nc, sb, sr, sc, s);
    case 2: return (int)run<2>(c, out, B, nr, nc, sb, sr, sc, s);
    case 3: return (int)run<3>(c, out, B, nr, nc, sb, sr, sc, s);
    default: return (int)run<4>(c, out, B, nr, nc, sb, sr, sc, s);
  }
}
