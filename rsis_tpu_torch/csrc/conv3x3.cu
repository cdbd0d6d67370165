// 3x3 SAME convolution in the (B, H, C, W) layout for Hopper (sm_90a),
// with packed weights: the cell backward's pullback conv (K3).
//
// Replaces: rsis_tpu/ops/pallas_decode.py::_conv3x3_rowmajor (kernel
// bodies _conv_kernel and _conv_kernel_dyfold), as the backward calls it
// through _conv_transpose_rowmajor (pallas_decode_vjp.py): the input is
// the gate cotangent dg (B, H, 4C, W) and the weight the flipped,
// transposed cell weight, so Cin = 4C (512 ... 32) and Cout = Cx + C (128,
// 192, 96, 48, 24 at hidden 128).
//
// Computes out[b, y, co, x] = sum_{tap, ci} wt[co, tap * Cin + ci] *
// in[b, y + tap / 3 - 1, ci, x + tap % 3 - 1] (zero outside the image),
// accumulated in fp32 and stored once in the input dtype. Output channels
// below Cx may go to a padded (B, H+2, Cx, W+2) tensor, whose ring the
// kernel zeroes, and the others to a (B, H, Cout - Cx, W) one: the
// pullback's dx_pad and dh_prev from one launch, no copies after it.
//
// What bounds it on the card: an implicit GEMM with M = B H W pixels, N =
// Cout and K = 9 Cin, against dg and the weight read once and the output
// written once. At the train step's cells (256x512 input, hidden 128, B =
// 32) cells 1-3 are 14.5 GFLOP each and cell 0 4.8: the tensor-core rate
// bounds cells 0-2 (0.005-0.015 ms) and the bytes bound cells 3-4 (Cin 64
// and 32 over 262k and 1M pixels, 0.018 and 0.035 ms).
//
// Design (bf16 with Cin a multiple of 16 and Cout and W multiples of 8;
// every cell of the decode):
//   1. The weight is staged once per block, not once per 16 pixels: a
//      block owns a unit of `rows` x `tw` output pixels (128-512 at the
//      train cells) and a tile of output channels (24-128 there), and
//      the contraction streams through shared memory in K-chunks of all
//      nine taps x `cc` input channels; every warp reads each chunk's
//      weight rows by ldmatrix. A block walks several units in turn where
//      the cell has more units than the card has SMs.
//   2. dg is staged as K5 stages its operands: a ring of 2-3 chunks filled
//      by 16-byte cp.async copies of dg's channel rows (the W pixels of a
//      channel are contiguous), zero-filled outside the image on all four
//      sides, with the weight chunk beside it. The next chunk's copies
//      (of this unit or the next) are in flight while the tensor cores
//      work on this one. Each chunk's halo is transposed once in shared
//      memory, [channel][pixel] -> [pixel][channel] by ldmatrix and
//      stmatrix.trans, so that a tap (dy, dx) is a whole-row offset for
//      the ldmatrix of the A fragments.
//   3. mma.sync m16n8k16, fp32 accumulators; a warp owns WM m-tiles of 16
//      pixels x WN n-tiles of 8 output channels (32-64 pixels x 24-64
//      channels at the train cells), so each A fragment serves WN n-tiles
//      and each B fragment WM m-tiles. mma.sync and not wgmma: the
//      narrowest cells have 24 and 48 output channels, and each tap's A
//      would need its own shifted descriptor.
//   4. The epilogue transposes the fp32 tile back through shared memory
//      (stmatrix.trans after one rounding to bf16) to the output's rows
//      and writes dh_prev (or the stacked output) with 16-byte stores;
//      dx_pad's (W + 2)-element rows start only 4-byte aligned and its
//      pixels one element in, so its channels go out as 32-bit words of
//      padded columns (the ring beside the block's pixels included),
//      neighbouring threads on neighbouring words.
//   5. Where the units alone leave most SMs idle (cell 0: 32 units of 128
//      pixels at B = 32, 8 at B = 8), the K-chunks are split: each part
//      writes an fp32 partial, and a second launch sums the partials in
//      split order. No atomics: two launches on the same inputs give the
//      same bits.
// The tile, unit, chunk, ring, split and grouping come from the host
// (conv3x3_plan in ops/conv3x3.py; chip_k5_step.py --k3-sweep times every
// alternative). Everything else (fp32, other widths) runs an fp32 FMA loop.

#include "cell_common.cuh"

namespace {

using rsis::cp_async16;
using rsis::cp_async_commit;
using rsis::cp_async_wait;
using rsis::from_f;
using rsis::kMaxSmem;
using rsis::kThreads;
using rsis::smem_addr;
using rsis::to_f;
using rsis::Walk;
using bf16 = __nv_bfloat16;

// Where output channel co of pixel (b, y, x) goes: channels below Cx to
// dxp (B, H+2, Cx, W+2) at (y + 1, x + 1), with the ring beside the pixel
// zeroed (each ring element by the one pixel it touches first: the
// corners by the image's corner pixels), the rest to dh (B, H, Cout - Cx,
// W). Cx = 0 with dh = out is the plain stacked (B, H, Cout, W) output.
template <typename T>
struct OutMap {
  T* dxp;
  T* dh;
  int H, W, Cout, Cx;
  __device__ __forceinline__ void put(int b, int y, int co, int x,
                                      T v) const {
    if (co >= Cx) {
      dh[((size_t)(b * H + y) * (Cout - Cx) + co - Cx) * W + x] = v;
      return;
    }
    const T zero = from_f<T>(0.0f);
    const int w2 = W + 2;
    T* row = dxp + ((size_t)(b * (H + 2) + y + 1) * Cx + co) * w2;
    row[x + 1] = v;
    if (x == 0) row[0] = zero;
    if (x == W - 1) row[W + 1] = zero;
    for (int e = 0; e < 2; ++e) {
      if (y != (e ? H - 1 : 0)) continue;
      T* edge = dxp + ((size_t)(b * (H + 2) + (e ? H + 1 : 0)) * Cx + co) *
                          w2;
      edge[x + 1] = zero;
      if (x == 0) edge[0] = zero;
      if (x == W - 1) edge[W + 1] = zero;
    }
  }
};

// The host's plan of a tensor-core launch: warps_m x warps_n warps of WM
// m-tiles x WN n-tiles, units of `rows` x `tw` pixels (rows * tw = 16 WM
// warps_m), K-chunks of `cc` channels in a ring of `stages`, the chunks
// cut into `splits` parts and the units dealt to `groups` blocks per
// (output tile, part).
struct MmaPlan {
  int warps_m, warps_n, rows, tw, cc, stages, splits, groups;
};

// Shared-memory layout of one block, in bf16 elements: the ring's raw dg
// rows, the weight slots (one when a block has one chunk: it stays), then
// the transposed halo, which the bf16 output tile reuses, and 8 elements
// of trash for stmatrix rows past the halo. Every region starts 16-byte
// aligned; each row stride is an odd number of 16-byte groups, so the 8
// rows of an ldmatrix or stmatrix hit 8 bank groups.
struct Smem {
  int rs, ks, cs, twp, os, raw, wgt, wslots, tile, stages;
  __host__ __device__ Smem(const MmaPlan& p, int nb, int cps) {
    rs = p.tw + 24;      // raw row: pixels x0 - 8 .. x0 + tw + 15
    ks = 9 * p.cc + 8;   // weight row: 9 taps x cc channels
    cs = p.cc + 8;       // halo row: the chunk's channels
    twp = p.tw + 2;      // halo rows per staged input row
    os = p.rows * p.tw + 8;   // output tile row: the unit's pixels
    raw = (p.rows + 2) * p.cc * rs;
    wgt = nb * ks;
    wslots = cps == 1 ? 1 : p.stages;
    const int halo = (p.rows + 2) * twp * cs;
    const int out = p.splits > 1 ? 0 : nb * os;
    tile = halo > out ? halo : out;
    stages = p.stages;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)(stages * raw + wslots * wgt + tile + 8) * sizeof(bf16);
  }
};

template <int WM, int WN>
__global__ void __launch_bounds__(kThreads, 1)
conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                OutMap<bf16> om, float* __restrict__ ws, int B, int H, int W,
                int Cin, int Cout, MmaPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = 8 * WN * p.warps_n;
  const int cps = Cin / p.cc / p.splits;   // chunks a block walks per unit
  const Smem L(p, nb, cps);
  bf16* raw0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* wgt0 = raw0 + L.stages * L.raw;
  bf16* tile = wgt0 + L.wslots * L.wgt;
  bf16* trash = tile + L.tile;

  const int R = p.rows;
  const int tw = p.tw;
  const int cc = p.cc;
  const int K = 9 * Cin;
  const int n_xt = (W + tw - 1) / tw;
  const int n_rg = (H + R - 1) / R;
  const long long n_units = (long long)B * n_rg * n_xt;
  const int group = blockIdx.x % p.groups;
  const int split = blockIdx.x / p.groups % p.splits;
  const int n0 = blockIdx.x / (p.groups * p.splits) * nb;
  const long long u_begin = n_units * group / p.groups;
  const int n_my = (int)(n_units * (group + 1) / p.groups - u_begin);
  const int c_begin = split * cps;
  const int n_st = n_my * cps;   // ring stages: (unit, chunk), chunk-minor

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int wmi = warp % p.warps_m;
  const int nw0 = warp / p.warps_m * 8 * WN;   // the warp's first channel

  auto unit_origin = [&](long long u, int& b, int& y0, int& x0) {
    x0 = (int)(u % n_xt) * tw;
    y0 = (int)(u / n_xt % n_rg) * R;
    b = (int)(u / ((long long)n_xt * n_rg));
  };

  // cp.async of stage k into ring slot k % stages: raw[(R + 2) rows][cc]
  // [rs] holds input rows y0 - 1 .. y0 + R, columns x0 - 8 .. x0 + tw + 7
  // of the chunk's channels (tw / 8 + 2 copies a row; zero outside the
  // image); the weight slot [nb][ks] the chunk's columns of the block's
  // output channels, tap-major (9 cc / 8 copies a row)
  const int qh = tw / 8 + 2;
  const Walk w_raw(threadIdx.x, blockDim.x, qh, cc);
  const Walk w_wgt(threadIdx.x, blockDim.x, cc / 8, 9);
  auto fetch = [&](int k) {
    const int slot = k % L.stages;
    int b, y0, x0;
    unit_origin(u_begin + k / cps, b, y0, x0);
    const int c0 = (c_begin + k % cps) * cc;
    bf16* raw = raw0 + slot * L.raw;
    Walk w = w_raw;
    for (int i = threadIdx.x; i < (R + 2) * cc * qh;
         i += blockDim.x, w.next()) {
      const int iy = y0 - 1 + w.c;
      const int ix = x0 - 8 + 8 * w.a;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(raw + (w.c * cc + w.b) * L.rs + 8 * w.a,
                 ok ? x + ((size_t)(b * H + iy) * Cin + c0 + w.b) * W + ix
                    : x,
                 ok ? 16 : 0);
    }
    if (cps == 1 && k > 0) return;   // the block's one chunk stays
    bf16* wg = wgt0 + (cps == 1 ? 0 : slot) * L.wgt;
    w = w_wgt;
    for (int i = threadIdx.x; i < nb * 9 * (cc / 8);
         i += blockDim.x, w.next())
      cp_async16(wg + w.c * L.ks + w.b * cc + 8 * w.a,
                 wt + (size_t)(n0 + w.c) * K + w.b * Cin + c0 + 8 * w.a, 16);
  };

  // raw (slot s) -> halo[(R + 2) rows][tw + 2 padded columns][cs] in 8x8
  // blocks (8 channels x 8 columns; raw column j is padded column j - 7),
  // four neighbouring column blocks a warp instruction: ldmatrix, then
  // stmatrix.trans; rows of a block outside the padded columns go to the
  // trash
  const int nq4 = (tw / 8 + 5) / 4;
  const int nquad = (R + 2) * (cc / 8) * nq4;
  const Walk w_t(warp, nw, nq4, cc / 8);
  auto transpose = [&](int slot) {
    const bf16* raw = raw0 + slot * L.raw;
    Walk w = w_t;
    for (int qd = warp; qd < nquad; qd += nw, w.next()) {
      const int r = w.c;
      const int g = w.b;
      const int q = 4 * w.a + (lane >> 3);
      unsigned v[4];
      rsis::ldmatrix_x4(v, raw + (r * cc + 8 * g + (lane & 7)) * L.rs +
                               8 * q);
      const int pc = 8 * q + (lane & 7) - 7;
      rsis::stmatrix_x4_trans(
          pc >= 0 && pc < L.twp ? tile + (r * L.twp + pc) * L.cs + 8 * g
                                : trash,
          v);
    }
  };

  float acc[WM][WN][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  };
  zero_acc();

  // the warp's m-tiles: unit pixel u_m[i] = r * tw + p (16 pixels of one
  // output row r); A rows by ldmatrix from halo row r + dy, column p + dx
  const unsigned tile_s = smem_addr(tile);
  int u_m[WM];
  unsigned a_base[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int mt = wmi * WM + i;
    const int r = mt / (tw / 16);
    const int px = mt % (tw / 16) * 16;
    u_m[i] = r * tw + px;
    a_base[i] = tile_s + (((r * L.twp + px + (lane & 15)) * L.cs) +
                          (lane >> 4) * 8) * 2;
  }
  // B rows: ldmatrix x4 matrices (n-tile j, k 0-7), (j, k 8-15), (j + 1,
  // k 0-7), (j + 1, k 8-15); x2 for an odd last n-tile
  const unsigned b_lane =
      ((nw0 + (lane & 7) + (lane >> 4) * 8) * L.ks + ((lane >> 3) & 1) * 8) *
      2;
  auto compute = [&](int slot) {
    const unsigned wb =
        smem_addr(wgt0 + (cps == 1 ? 0 : slot) * L.wgt) + b_lane;
    for (int kk = 0; kk < cc; kk += 16) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const unsigned a_off =
            (((tap / 3) * L.twp + tap % 3) * L.cs + kk) * 2;
        const unsigned b_off = wb + (tap * cc + kk) * 2;
        unsigned a[WM][4];
#pragma unroll
        for (int i = 0; i < WM; ++i) rsis::ldsm_x4(a[i], a_base[i] + a_off);
        unsigned bf[WN][2];
#pragma unroll
        for (int j = 0; j + 1 < WN; j += 2) {
          unsigned t4[4];
          rsis::ldsm_x4(t4, b_off + j * 8 * L.ks * 2);
          bf[j][0] = t4[0];
          bf[j][1] = t4[1];
          bf[j + 1][0] = t4[2];
          bf[j + 1][1] = t4[3];
        }
        if constexpr (WN % 2 == 1) {
          unsigned t2[2];
          rsis::ldsm_x2(t2, b_off + (WN - 1) * 8 * L.ks * 2);
          bf[WN - 1][0] = t2[0];
          bf[WN - 1][1] = t2[1];
        }
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            rsis::mma_bf16(acc[i][j], a[i], bf[j][0], bf[j][1]);
      }
    }
  };

  // D fragment: pixels lane / 4 (+ 8), channels 2 (lane % 4) (+ 1)
  auto epilogue = [&](long long u) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    if (p.splits > 1) {
      // fp32 partial of this part in the output's layout, straight from
      // the fragments (a quad's 8 pixels are one 32-byte sector)
      float* part = ws + (size_t)split * ((size_t)B * H * Cout * W);
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int y = y0 + u_m[i] / tw;
        if (y >= H) continue;
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int xx = x0 + u_m[i] % tw + (lane >> 2) + (e >> 1) * 8;
            const int co = n0 + nw0 + 8 * j + 2 * (lane & 3) + (e & 1);
            if (xx < W)
              part[((size_t)(b * H + y) * Cout + co) * W + xx] =
                  acc[i][j][e];
          }
      }
      zero_acc();
      return;
    }
    __syncthreads();   // every warp is done with the halo the tile reuses
    // tile[nb][os]: channel rows of the unit's pixels, by stmatrix.trans
    // of the bf16-rounded fragments: x4 matrices (j, pixels 0-7), (j,
    // 8-15), (j + 1, 0-7), (j + 1, 8-15)
    const unsigned o_lane =
        tile_s + ((nw0 + (lane & 7) + (lane >> 4) * 8) * L.os +
                  ((lane >> 3) & 1) * 8) * 2;
    auto pack = [](float lo, float hi) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      return *reinterpret_cast<const unsigned*>(&v);
    };
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int j = 0; j + 1 < WN; j += 2) {
        const unsigned v[4] = {pack(acc[i][j][0], acc[i][j][1]),
                               pack(acc[i][j][2], acc[i][j][3]),
                               pack(acc[i][j + 1][0], acc[i][j + 1][1]),
                               pack(acc[i][j + 1][2], acc[i][j + 1][3])};
        rsis::stsm_x4_trans(o_lane + (j * 8 * L.os + u_m[i]) * 2, v);
      }
      if constexpr (WN % 2 == 1) {
        const unsigned v[2] = {pack(acc[i][WN - 1][0], acc[i][WN - 1][1]),
                               pack(acc[i][WN - 1][2], acc[i][WN - 1][3])};
        rsis::stsm_x2_trans(o_lane + ((WN - 1) * 8 * L.os + u_m[i]) * 2, v);
      }
    }
    zero_acc();
    __syncthreads();
    // channels from Cx on: 16-byte stores of 8 pixels, neighbouring
    // threads on neighbouring pieces of a row
    const int nbx = max(0, min(nb, om.Cx - n0));   // the block's dx rows
    const int C = Cout - om.Cx;
    Walk w(threadIdx.x, blockDim.x, tw / 8, R);
    for (int i = threadIdx.x; i < (nb - nbx) * R * (tw / 8);
         i += blockDim.x, w.next()) {
      const int y = y0 + w.b;
      const int xx = x0 + 8 * w.a;
      if (y >= H || xx >= W) continue;
      const int cl = nbx + w.c;
      *reinterpret_cast<uint4*>(
          om.dh + ((size_t)(b * H + y) * C + n0 + cl - om.Cx) * W + xx) =
          *reinterpret_cast<const uint4*>(tile + cl * L.os + w.b * tw +
                                          8 * w.a);
    }
    if (nbx == 0) return;
    // channels below Cx: dx_pad's rows start 4-byte aligned ((W + 2)
    // elements), so 32-bit words of padded columns pc, pc + 1 (pc even)
    // from x0 to x0 + tw; the block writes its pixels and the ring beside
    // them (padded row 0 above image row 0, H + 1 below H - 1, columns 0
    // and W + 1 beside x = 0 and W - 1), half words where a word's other
    // column is a neighbour's
    const int xe = min(x0 + tw, W);
    const int ye = min(y0 + R, H);
    const int pr0 = y0 == 0 ? 0 : 1;   // padded rows y0 + pr0 .. y0 + pr1 - 1
    const int pr1 = ye - y0 + 1 + (ye == H ? 1 : 0);
    const int nwd = tw / 2 + 1;
    w = Walk(threadIdx.x, blockDim.x, nwd, pr1 - pr0);
    for (int i = threadIdx.x; i < nbx * (pr1 - pr0) * nwd;
         i += blockDim.x, w.next()) {
      const int py = y0 + pr0 + w.b;
      const int pc = x0 + 2 * w.a;
      const bool inside = py >= 1 && py <= H;
      bf16 v[2];
      bool put[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int xx = pc - 1 + e;
        const bool own = xx >= x0 && xx < xe;
        put[e] = own || (xx == -1) || (xx == W && xe == W);
        v[e] = own && inside
                   ? tile[w.c * L.os + (py - 1 - y0) * tw + xx - x0]
                   : __float2bfloat16_rn(0.0f);
      }
      bf16* dst = om.dxp +
                  ((size_t)(b * (H + 2) + py) * om.Cx + n0 + w.c) * (W + 2) +
                  pc;
      if (put[0] && put[1])
        *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(v[0],
                                                                     v[1]);
      else if (put[0])
        dst[0] = v[0];
      else if (put[1])
        dst[1] = v[1];
    }
  };

  // the ring: stage k waits for its copies, the slot freed by stage k - 1
  // takes stage k + stages - 1, then stage k is transposed and multiplied;
  // a unit's last chunk ends in its epilogue
  for (int s = 0; s < L.stages - 1; ++s) {
    if (s < n_st) fetch(s);
    cp_async_commit();
  }
  for (int k = 0; k < n_st; ++k) {
    if (L.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int next = k + L.stages - 1;
    if (next < n_st) fetch(next);
    cp_async_commit();
    transpose(k % L.stages);
    __syncthreads();
    compute(k % L.stages);
    if (k % cps == cps - 1) epilogue(u_begin + k / cps);
  }
  cp_async_wait<0>();
}

// out = sum over parts s in order of ws[s], through the output map.
template <typename T>
__global__ void conv_reduce_kernel(const float* __restrict__ ws,
                                   OutMap<T> om, int splits, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[(size_t)k * n + i];
  const int x = (int)(i % om.W);
  const int co = (int)(i / om.W % om.Cout);
  const long long by = i / ((long long)om.W * om.Cout);
  om.put((int)(by / om.H), (int)(by % om.H), co, x, from_f<T>(s));
}

// One block: image b, output row y, columns [x0, x0 + tw). Threads are
// ceil(Cout / G) channel groups x (tw / P) pixel groups.
template <typename T, int G, int P>
__global__ void __launch_bounds__(kThreads)
conv_fma_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                OutMap<T> om, int H, int W, int Cin, int Cout, int tw,
                int n_tiles) {
  extern __shared__ float tile[];  // [3 rows][Cin][tw + 2 cols]
  const int twp = tw + 2;
  const int K = 9 * Cin;
  const int pgs = tw / P;
  const int xt = blockIdx.x % n_tiles;
  const int y = (blockIdx.x / n_tiles) % H;
  const int b = blockIdx.x / (n_tiles * H);
  const int x0 = xt * tw;
  rsis::stage_halo(x, x, b, y, x0, H, W, Cin, 0, twp, 3,
                   [&](int dy, int ch, int col, T v) {
                     tile[(dy * Cin + ch) * twp + col] = to_f(v);
                   });
  __syncthreads();

  const int pg = threadIdx.x % pgs;
  const int cg = threadIdx.x / pgs;
  float acc[G][P];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < P; ++j) acc[gi][j] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const float* trow = tile + (size_t)(tap / 3 * Cin) * twp + tap % 3 + pg;
    for (int ci = 0; ci < Cin; ++ci) {
      const float* src = trow + (size_t)ci * twp;
      float in[P];
#pragma unroll
      for (int j = 0; j < P; ++j) in[j] = src[j * pgs];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int co = cg * G + gi;
        const float w =
            co < Cout ? to_f(wt[(size_t)co * K + tap * Cin + ci]) : 0.0f;
#pragma unroll
        for (int j = 0; j < P; ++j) acc[gi][j] = fmaf(w, in[j], acc[gi][j]);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int co = cg * G + gi;
    if (co >= Cout) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int px = x0 + pg + j * pgs;
      if (px < W) om.put(b, y, co, px, from_f<T>(acc[gi][j]));
    }
  }
}

template <int WM, int WN>
cudaError_t launch_mma(const bf16* x, const bf16* wt, OutMap<bf16> om,
                       float* ws, int B, int H, int W, int Cin, int Cout,
                       const MmaPlan& p, cudaStream_t s) {
  const int nb = 8 * WN * p.warps_n;
  const size_t smem = Smem(p, nb, Cin / p.cc / p.splits).bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_mma_kernel<WM, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)(Cout / nb) * p.splits * p.groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_mma_kernel<WM, WN><<<(unsigned)blocks, 32 * p.warps_m * p.warps_n,
                            smem, s>>>(x, wt, om, ws, B, H, W, Cin, Cout, p);
  return cudaGetLastError();
}

template <int WM>
cudaError_t dispatch_wn(int wn, const bf16* x, const bf16* wt,
                        OutMap<bf16> om, float* ws, int B, int H, int W,
                        int Cin, int Cout, const MmaPlan& p,
                        cudaStream_t s) {
  switch (wn) {
    case 1: return launch_mma<WM, 1>(x, wt, om, ws, B, H, W, Cin, Cout, p, s);
    case 2: return launch_mma<WM, 2>(x, wt, om, ws, B, H, W, Cin, Cout, p, s);
    case 3: return launch_mma<WM, 3>(x, wt, om, ws, B, H, W, Cin, Cout, p, s);
    case 4: return launch_mma<WM, 4>(x, wt, om, ws, B, H, W, Cin, Cout, p, s);
    case 6: return launch_mma<WM, 6>(x, wt, om, ws, B, H, W, Cin, Cout, p, s);
    case 8: return launch_mma<WM, 8>(x, wt, om, ws, B, H, W, Cin, Cout, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int G, int P>
cudaError_t launch_fma(const void* x, const void* wt, OutMap<T> om, int B,
                       int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const int cgs = (Cout + G - 1) / G;
  if (cgs > kThreads) return cudaErrorInvalidValue;
  int pgs = kThreads / cgs;
  const int need = (W + P - 1) / P;
  if (pgs > need) pgs = need;
  size_t smem = 0;
  while (true) {
    smem = (size_t)3 * Cin * (pgs * P + 2) * sizeof(float);
    if (smem <= kMaxSmem || pgs == 1) break;
    pgs /= 2;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int tw = pgs * P;
  const int n_tiles = (W + tw - 1) / tw;
  auto kern = conv_fma_kernel<T, G, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, pgs * cgs, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), om, H, W, Cin,
      Cout, tw, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, Cin, W), wt (Cout, 9 * Cin) tap-major, channel-minor. Output
// channels below Cx go to dxp (B, H+2, Cx, W+2) with its ring zeroed
// (null when Cx == 0), the others to dh (B, H, Cout - Cx, W); Cx = 0 and
// dh = out give the stacked (B, H, Cout, W) output. dtype: 0 = float32,
// 1 = bfloat16 (all operands alike). The plan (conv3x3_plan): mma = 0 runs
// the FMA loop (the other fields unused); mma = 1 the tensor-core loop
// (bfloat16, Cin % 16 == 0, Cout % 8 == 0, W % 8 == 0) with warp tiles of
// wm m-tiles x wn n-tiles, warps_m x warps_n warps, units of rows x tw
// pixels (rows * tw == 16 wm warps_m), K-chunks of cc channels in a ring
// of `stages`, `splits` parts of the chunks (ws then holds at least
// splits * B * H * Cout * W floats) and `groups` blocks of units. Returns
// the first failing launch's cudaError_t, 0 on success;
// cudaErrorInvalidValue for a plan or operands that do not fit.
extern "C" int rsis_conv3x3(const void* x, const void* wt, void* dxp,
                            void* dh, void* ws, long long ws_floats, int B,
                            int H, int W, int Cin, int Cout, int Cx,
                            int dtype, int mma, int wm, int wn, int warps_m,
                            int warps_n, int rows, int tw, int cc,
                            int stages, int splits, int groups,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cx < 0 ||
      Cx >= Cout || (Cx > 0) != (dxp != nullptr) || dh == nullptr ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mma) {
    if (dtype == 0)
      return (int)launch_fma<float, 4, 4>(
          x, wt, OutMap<float>{static_cast<float*>(dxp),
                               static_cast<float*>(dh), H, W, Cout, Cx},
          B, H, W, Cin, Cout, s);
    return (int)launch_fma<bf16, 4, 4>(
        x, wt, OutMap<bf16>{static_cast<bf16*>(dxp), static_cast<bf16*>(dh),
                            H, W, Cout, Cx},
        B, H, W, Cin, Cout, s);
  }
  const long long units =
      (long long)B * ((H + rows - 1) / (rows > 0 ? rows : 1)) *
      ((W + tw - 1) / (tw > 0 ? tw : 1));
  const long long n_out = (long long)B * H * Cout * W;
  if (dtype != 1 || Cin % 16 || Cout % 8 || W % 8 ||
      (wm != 1 && wm != 2 && wm != 4) || wn < 1 || wn > 8 || wn == 5 ||
      wn == 7 || warps_m < 1 || warps_n < 1 || warps_m * warps_n > 8 ||
      Cout % (8 * wn * warps_n) || rows < 1 || tw < 16 || tw % 16 ||
      rows * tw != 16 * wm * warps_m || cc < 16 || cc % 16 || Cin % cc ||
      (stages != 2 && stages != 3) || splits < 1 || (Cin / cc) % splits ||
      groups < 1 || groups > units ||
      (splits > 1 && (ws == nullptr || ws_floats < splits * n_out)))
    return (int)cudaErrorInvalidValue;
  const MmaPlan p{warps_m, warps_n, rows, tw, cc, stages, splits, groups};
  const OutMap<bf16> om{static_cast<bf16*>(dxp), static_cast<bf16*>(dh), H,
                        W, Cout, Cx};
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wt);
  float* wsp = static_cast<float*>(ws);
  cudaError_t err;
  if (wm == 1)
    err = dispatch_wn<1>(wn, xp, wp, om, wsp, B, H, W, Cin, Cout, p, s);
  else if (wm == 2)
    err = dispatch_wn<2>(wn, xp, wp, om, wsp, B, H, W, Cin, Cout, p, s);
  else
    err = dispatch_wn<4>(wn, xp, wp, om, wsp, B, H, W, Cin, Cout, p, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int threads = 256;
  conv_reduce_kernel<bf16><<<(unsigned)((n_out + threads - 1) / threads),
                             threads, 0, s>>>(wsp, om, splits, n_out);
  return (int)cudaGetLastError();
}
