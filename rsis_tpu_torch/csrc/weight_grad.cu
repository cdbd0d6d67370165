// Weight gradient of the ConvLSTM gate convolution for Hopper (sm_90a).
//
// Replaces: rsis_tpu/ops/pallas_decode_vjp.py::weight_grad_rowmajor
// (kernel body _dwt_kernel). Computes
//   dwt[n, k] = sum over pixels (b, y, x) of dg[b, y, n, x] * tap_k(b, y, x)
// for the packed (4C, 9(Cx+C)) layout of pack_cell_weights, where column
// k = (tap, channel) reads x_pad[b, y + dy, ch, x + dx] for the Cx x
// channels (the ring read as given) and h_prev[b, y + dy - 1, ch - Cx,
// x + dx - 1] for the C h channels (zero outside the image). The sum is
// taken in fp32 and cast once to dg's dtype.
//
// What bounds it on the card: a GEMM with M = 4C, N = 9(Cx+C) and the
// contraction over K = B * H * W pixels, against dg, h_prev and x_pad read
// once. At the train step's cells (256x512 input, hidden 128, B = 32)
// cells 1-4 are about 14.5 GFLOP each and cell 0 4.8: the tensor-core rate
// bounds cells 0-2 (M >= 128; 0.005-0.015 ms) and the bytes bound cells 3-4
// (M = 64 and 32, up to 1M pixels and 112 MB at the finest; 0.018 and
// 0.035 ms).
//
// Design (bf16 with C, Cx and W multiples of 8: every cell of the decode):
//   - One launch sums pixel chunks into fp32 partial tiles; a second
//     launch adds the chunks in chunk order, so the result is the same on
//     every run (no atomics). Block (output tile, chunk) owns a tile of
//     Mb gate rows x Cb input channels x 9 taps and walks its chunk's
//     units (image, `rows` output rows, `tw` output columns) in order.
//   - Staging is asynchronous: a ring of 2-3 units in shared memory
//     filled by 16-byte cp.async copies of dg's and h's rows and of
//     x_pad's rows from the 16-byte boundary at or before the unit (its
//     (W + 2)-element rows are 4-byte aligned only; each row's phase is
//     undone when it is transposed), zero-filled past the image, so the
//     next unit's bytes are in flight while the tensor cores work.
//   - The tap shift runs along the contiguous pixel axis, where ldmatrix
//     cannot start a row at an odd pixel. The halo is therefore
//     transposed once per unit in shared memory, [channel][pixel] ->
//     [pixel][channel], 8x8 blocks at a time (ldmatrix, or 32-bit loads
//     at an x row's phase, then stmatrix.trans), after which a shift by
//     dx moves whole 16-byte rows and B comes from ldmatrix.trans.
//   - mma.sync m16n8k16 with fp32 accumulators: a warp owns 16 WA gate
//     rows x 8 WC channels x 9 taps (WA, WC in {1, 2}); A (dg, [pixel]
//     contiguous) by ldmatrix, B (the shifted halo) by ldmatrix.trans.
//     mma.sync and not wgmma: the narrowest cells have 32 gate rows,
//     half of wgmma's 64, and each tap's B would need its own shifted
//     descriptor; staging, which overlaps the multiply only between
//     blocks, costs as much as the multiply at every cell, so the design
//     spends on it first.
//   - The tile, unit, ring and number of chunks come from the host
//     (weight_grad_plan in ops/fused_cell_vjp.py; chip_k5_step.py --sweep
//     times every alternative): at the bench geometry 128 x 32 tiles of
//     eight 32 x 16 warps and 128-pixel units at cells 0-2, 64 x 48 and
//     256 pixels at cell 3, the whole 32 x 24 gradient in six 16 x 8
//     warps, two blocks an SM, at cell 4.
//
// Everything else (fp32; bf16 where C, Cx or W is not a multiple of 8)
// runs a register-tiled fp32 FMA loop into the same partials. What bounds
// it: the operations at the card's 67 TFLOP/s of fp32 FMA. At the Pascal
// recipe's cells (256x256 input, hidden 128, B = 28) cells 1-4 are 6.34
// GFLOP each and cell 0 2.1, 0.41 ms a decode step, against 1-100 MB of
// operands (0.03 ms at most). So every instruction that is not an FMA
// costs time:
//   - A block owns Mb gate rows x Cb channels x 9 taps and stages each
//     unit of `rows` x `tw` pixels once for all nine taps: dg's rows and
//     the (rows + 2) x (tw + 2) halo of its channels, in fp32 at their
//     pixel and padded column, so a tap is an offset into the halo.
//   - Staging is asynchronous: a ring of 2-3 units filled by cp.async
//     (16-byte copies of dg's rows where W % 4 == 0, 4-byte copies of the
//     halo at any phase; bf16 is loaded and converted instead), the index
//     math done once per copy by the Walk counters.
//   - Each thread keeps 8 gate rows x 2 channels x 9 taps = 144
//     accumulators and per 4-pixel quad reads 8 + 6 x 2 = 20 float4 from
//     shared memory for 576 FMAs.
//   - Small cells split a block's threads into pixel groups that take
//     every groups-th quad; their tiles are added in group order at the
//     end. Chunks as above, so two launches give the same bits.
//   - The tile, groups, unit, ring and chunks come from weight_grad_plan,
//     a fixed rule (chip_k5_step.py --fma-sweep times the plans around
//     it).

#include <stdint.h>

#include "cell_common.cuh"

namespace {

using rsis::cp_async16;
using rsis::cp_async_commit;
using rsis::cp_async_wait;
using rsis::from_f;
using rsis::ldmatrix_x4_trans;
using rsis::stmatrix_x4_trans;
using rsis::Walk;
using bf16 = __nv_bfloat16;

constexpr size_t kSmemLimit = 227 * 1024;

// Packed column of channel ch (of Cx + C) at tap t.
__device__ __forceinline__ int packed_col(int tap, int ch, int C, int Cx) {
  return ch < Cx ? tap * Cx + ch : 9 * Cx + tap * C + (ch - Cx);
}

// The host's plan of a tensor-core launch: block tile Mb = 16 WA wm gate
// rows x Cb = 8 WC wc channels (wm x wc warps), units of `rows` x `tw`
// output pixels, a ring of `stages` units, `chunks` pixel chunks.
struct MmaPlan {
  int wm, wc, rows, tw, stages, chunks;
};

// Shared-memory layout of one block, in bf16 elements. Every region
// starts 16-byte aligned; each row stride is an odd number of 16-byte
// groups, so the 8 rows of an ldmatrix or stmatrix hit 8 bank groups.
struct Smem {
  int rs, ds, cs, twp, raw, dgn, ring, halo;
  __host__ __device__ Smem(const MmaPlan& p, int mb, int cb) {
    rs = p.tw + 24;   // raw row: pixels x0 - 8 .. x0 + tw + 15 (h)
    ds = p.tw + 8;    // dg row: pixels x0 .. x0 + tw - 1
    cs = cb + ((cb / 8) % 2 ? 0 : 8);   // halo row: the block's channels
    twp = p.tw + 2;   // halo rows per staged input row: padded columns
    raw = (p.rows + 2) * cb * rs;
    dgn = p.rows * mb * ds;
    ring = p.stages * (raw + dgn);
    halo = (p.rows + 2) * twp * cs;
  }
  // ring, halo, then 8 elements of trash for stmatrix rows past the halo
  __host__ __device__ size_t bytes() const {
    return (size_t)(ring + halo + 8) * sizeof(bf16);
  }
};

// Blocks an SM holds at once: one with the 32 x 16 warp tile (144
// accumulators a thread), two with the smaller ones (at most 128 registers
// a thread), where the plan's shared memory allows it.
template <int WA, int WC>
constexpr int kMinBlocks = WA * WC == 4 ? 1 : 2;

template <int WA, int WC>
__global__ void __launch_bounds__(256, (kMinBlocks<WA, WC>))
dwt_mma_kernel(const bf16* __restrict__ h_prev,
               const bf16* __restrict__ x_pad, const bf16* __restrict__ dg,
               float* __restrict__ ws, int B, int H, int W, int C, int Cx,
               MmaPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cn = Cx + C;
  const int M = 4 * C;
  const int K = 9 * cn;
  const int mb = 16 * WA * p.wm;
  const int cb = 8 * WC * p.wc;
  const int R = p.rows;
  const int tw = p.tw;
  const Smem L(p, mb, cb);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* halo = ring + L.ring;
  bf16* trash = halo + L.halo;

  const int n_mt = M / mb;
  const int n_ct = cn / cb;
  const int m0 = (blockIdx.x % n_mt) * mb;
  const int c0 = (blockIdx.x / n_mt % n_ct) * cb;
  const int chunk = blockIdx.x / (n_mt * n_ct);
  const int n_xt = (W + tw - 1) / tw;
  const int n_rg = (H + R - 1) / R;
  const long long n_units = (long long)B * n_rg * n_xt;
  const int u_begin = (int)(n_units * chunk / p.chunks);
  const int n_my = (int)(n_units * (chunk + 1) / p.chunks) - u_begin;
  // the block's channels: cxb x channels (c0 ..), then h channels from ch0
  const int cxb = max(0, min(cb, Cx - c0));
  const int ch0 = max(c0, Cx) - Cx;
  const int chb = cb - cxb;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mw = 16 * WA * (warp % p.wm);   // the warp's first gate row
  const int cw = 8 * WC * (warp / p.wm);    // the warp's first channel

  auto unit_origin = [&](int u, int& b, int& y0, int& x0) {
    x0 = (u % n_xt) * tw;
    y0 = (u / n_xt % n_rg) * R;
    b = u / (n_xt * n_rg);
  };

  // x_pad's row (b, py, x channel ch) starts at element x_row(b, py, ch);
  // (W + 2)-element rows are 4-byte but not 16-byte aligned: a row is
  // staged from the 16-byte boundary at or before padded column x0, and
  // its phase x_phase = (x_row + x0) % 8 (even) says where x0 landed
  const long long x_numel = (long long)B * (H + 2) * Cx * (W + 2);
  auto x_row = [&](int b, int py, int ch) {
    return ((long long)(b * (H + 2) + py) * Cx + ch) * (W + 2);
  };

  // cp.async of unit u into ring slot s: raw[(R + 2) rows][cb][rs] holds,
  // from column 0, x_pad's row from 16-byte boundary (padded column x0 at
  // its phase, tw/8 + 1 copies) and h's columns x0 - 8 .. x0 + tw + 7
  // (tw/8 + 2 copies); dg[R][mb][ds] columns x0 .. x0 + tw - 1. Each
  // thread walks (row, channel, column) of the three copies; bytes past
  // the image (and past x_pad's end) are zero.
  const int qn = tw / 8;       // dg: 16-byte copies a row
  const int qx = tw / 8 + 1;   // x
  const int qh = tw / 8 + 2;   // h
  const Walk w_dg(threadIdx.x, blockDim.x, qn, mb);
  const Walk w_x(threadIdx.x, blockDim.x, qx, cxb);
  const Walk w_h(threadIdx.x, blockDim.x, qh, chb);
  auto fetch = [&](int u, int s) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    bf16* raw = ring + (size_t)s * (L.raw + L.dgn);
    bf16* dgs = raw + L.raw;
    Walk w = w_dg;
    for (int i = threadIdx.x; i < R * mb * qn; i += blockDim.x, w.next()) {
      const int y = y0 + w.c;
      const int x = x0 + 8 * w.a;
      const bool ok = y < H && x < W;
      cp_async16(dgs + (w.c * mb + w.b) * L.ds + 8 * w.a,
                 ok ? dg + ((size_t)(b * H + y) * M + m0 + w.b) * W + x : dg,
                 ok ? 16 : 0);
    }
    w = w_x;
    for (int i = threadIdx.x; i < (R + 2) * cxb * qx;
         i += blockDim.x, w.next()) {
      const long long e = ((x_row(b, y0 + w.c, c0 + w.b) + x0) & ~7LL) +
                          8 * w.a;
      const bool ok = y0 + w.c < H + 2 && e < x_numel;
      cp_async16(raw + (w.c * cb + w.b) * L.rs + 8 * w.a,
                 ok ? x_pad + e : dg,
                 ok ? (int)min(16LL, 2 * (x_numel - e)) : 0);
    }
    w = w_h;
    for (int i = threadIdx.x; i < (R + 2) * chb * qh;
         i += blockDim.x, w.next()) {
      const int iy = y0 + w.c - 1;
      const int ix = x0 - 8 + 8 * w.a;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(raw + (w.c * cb + cxb + w.b) * L.rs + 8 * w.a,
                 ok ? h_prev + ((size_t)(b * H + iy) * C + ch0 + w.b) * W +
                          ix
                    : dg,
                 ok ? 16 : 0);
    }
  };

  // raw (slot s) -> halo[(R + 2) rows][tw + 2 padded columns][cs] in 8x8
  // blocks (8 channels x 8 padded columns), four neighbouring column
  // blocks a warp instruction: x rows by 32-bit loads at their phase, h
  // rows by ldmatrix (raw column j is padded column j - 7), either way
  // the fragment ldmatrix would give, then stmatrix.trans; rows of a
  // block outside the padded columns go to the trash
  const int nq4 = (tw / 8 + 5) / 4;   // quads of column blocks a row
  const int nquad = (R + 2) * (cb / 8) * nq4;
  const int nw = blockDim.x / 32;
  const Walk w_t(warp, nw, nq4, cb / 8);
  auto transpose = [&](int u, int s) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    const bf16* raw = ring + (size_t)s * (L.raw + L.dgn);
    Walk w = w_t;
    for (int qd = warp; qd < nquad; qd += nw, w.next()) {
      const int r = w.c;
      const int g = w.b;
      const int q = 4 * w.a + (lane >> 3);   // this lane's store block
      const bool is_h = 8 * g >= cxb;
      unsigned v[4];
      if (is_h) {
        rsis::ldmatrix_x4(v, raw + (r * cb + 8 * g + (lane & 7)) * L.rs +
                                 8 * q);
      } else {
        const int c = 8 * g + (lane >> 2);
        const int phase = (int)((x_row(b, y0 + r, c0 + c) + x0) & 7);
        const bf16* row = raw + (r * cb + c) * L.rs + phase + 2 * (lane & 3);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          v[m] = *reinterpret_cast<const unsigned*>(row + 8 * (4 * w.a + m));
      }
      const int pc = 8 * q + (lane & 7) - (is_h ? 7 : 0);
      stmatrix_x4_trans(pc >= 0 && pc < L.twp
                            ? halo + (size_t)(r * L.twp + pc) * L.cs + 8 * g
                            : trash,
                        v);
    }
  };

  float acc[WA][WC][9][4];
#pragma unroll
  for (int a = 0; a < WA; ++a)
#pragma unroll
    for (int c = 0; c < WC; ++c)
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][c][t][e] = 0.0f;

  // ldmatrix rows: A matrix (lane >> 3) = (gate half, pixel half); B
  // matrix (lane >> 3) & 1 = pixel half, lane >> 4 = channel block (x4)
  const int a_m = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_p = (lane >> 4) * 8;
  const int b_p = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_c = (lane >> 4) * 8;

  auto compute = [&](int s, int u) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    const bf16* dgs = ring + (size_t)s * (L.raw + L.dgn) + L.raw;
    const int r_end = min(R, H - y0);
    const int p_end = min(tw, W - x0);
    for (int r = 0; r < r_end; ++r) {
      for (int p0 = 0; p0 < p_end; p0 += 16) {
        unsigned a[WA][4];
#pragma unroll
        for (int wa = 0; wa < WA; ++wa)
          rsis::ldmatrix_x4(
              a[wa], dgs + (r * mb + mw + 16 * wa + a_m) * L.ds + p0 + a_p);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const bf16* bp =
              halo + (size_t)((r + t / 3) * L.twp + p0 + t % 3 + b_p) * L.cs +
              cw;
          if constexpr (WC == 2) {
            unsigned bb[4];
            ldmatrix_x4_trans(bb, bp + b_c);
#pragma unroll
            for (int wa = 0; wa < WA; ++wa) {
              rsis::mma_bf16(acc[wa][0][t], a[wa], bb[0], bb[1]);
              rsis::mma_bf16(acc[wa][1][t], a[wa], bb[2], bb[3]);
            }
          } else {
            unsigned bb[2];
            rsis::ldmatrix_x2_trans(bb, bp);
#pragma unroll
            for (int wa = 0; wa < WA; ++wa)
              rsis::mma_bf16(acc[wa][0][t], a[wa], bb[0], bb[1]);
          }
        }
      }
    }
  };

  // the ring: unit k waits for its copies, the slot freed by unit k - 1
  // takes unit k + stages - 1, then unit k is transposed and multiplied
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < n_my) fetch(u_begin + s, s);
    cp_async_commit();
  }
  for (int k = 0; k < n_my; ++k) {
    if (p.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int next = k + p.stages - 1;
    if (next < n_my) fetch(u_begin + next, next % p.stages);
    cp_async_commit();
    transpose(u_begin + k, k % p.stages);
    __syncthreads();
    compute(k % p.stages, u_begin + k);
  }
  cp_async_wait<0>();

  // D fragment: rows lane / 4 (+ 8), columns 2 * (lane % 4) (+ 1): two
  // neighbouring channels are neighbouring packed columns
  float* out = ws + (size_t)chunk * M * K;
#pragma unroll
  for (int wa = 0; wa < WA; ++wa)
#pragma unroll
    for (int wc = 0; wc < WC; ++wc)
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + mw + 16 * wa + (lane >> 2) + 8 * half;
          const int ch = c0 + cw + 8 * wc + 2 * (lane & 3);
          *reinterpret_cast<float2*>(out + (size_t)m * K +
                                     packed_col(t, ch, C, Cx)) =
              make_float2(acc[wa][wc][t][2 * half],
                          acc[wa][wc][t][2 * half + 1]);
        }
}

// ---- the FMA loop (fp32, and bf16 where C, Cx or W is not a multiple of 8)

// 4 bytes to shared memory, from src when `bytes` is 4, else zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// One staged element, as fp32 (0 where !ok): fp32 by an asynchronous
// copy, bf16 loaded and converted on the spot.
__device__ __forceinline__ void stage_one(float* dst, const float* src,
                                          bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void stage_one(float* dst, const bf16* src,
                                          bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}

// The FMA loop's thread tile: kTm gate rows x kTc channels x 9 taps, 144
// accumulators, so one block of at most 256 threads an SM.
constexpr int kTm = 8;
constexpr int kTc = 2;

// The host's plan of an FMA launch: tm x tc threads a pixel group,
// `groups` pixel groups a block, units of `rows` x `tw` output pixels, a
// ring of `stages` units, `chunks` pixel chunks.
struct FmaPlan {
  int tm, tc, groups, rows, tw, stages, chunks;
};

// Shared memory of one FMA block, in floats: a ring of `stages` units,
// each dg[rows][mb][ds] (pixel x at x) and the halo[cb][cs] of rows + 2
// padded rows of hs floats (padded column j at j); at the end the pixel
// groups' tiles reuse it. ds / 4 and cs / 4 are odd, so the float4 reads
// of 8 neighbouring gate rows or channels at one pixel hit 8 different
// groups of 4 banks.
struct FmaSmem {
  int ds, hs, cs, dgn, stage, reduce;
  __host__ __device__ FmaSmem(const FmaPlan& p, int mb, int cb) {
    ds = p.tw / 4 % 2 ? p.tw : p.tw + 4;
    hs = p.tw + 4;   // padded columns 0 .. tw + 1 staged, read to tw + 3
    cs = (p.rows + 2) * hs;
    if (cs / 4 % 2 == 0) cs += 4;
    dgn = p.rows * mb * ds;
    stage = dgn + cb * cs;
    reduce = (p.groups - 1) * mb * cb * 9;
  }
  __host__ __device__ size_t bytes(int stages) const {
    const int n = stages * stage;
    return (size_t)(n > reduce ? n : reduce) * sizeof(float);
  }
};

// fp32 FMA, register-tiled: block (output tile, chunk) owns mb = kTm tm
// gate rows x cb = kTc tc input channels x 9 taps and walks its chunk's
// units in order. Thread (cg, rg) of pixel group kg owns gate rows
// rg + i tm and channels cg + j tc; for each 4-pixel quad of its group it
// reads kTm float4 of dg and, per channel and dy, two float4 of the halo
// row (the 6 padded columns the quad's three dx taps read), then does
// kTm x kTc x 9 x 4 FMAs. The pixel groups' tiles are added in group
// order at the end, so the sum is the same on every run.
template <typename T>
__global__ void __launch_bounds__(256, 1)
dwt_tiled_kernel(const T* __restrict__ h_prev, const T* __restrict__ x_pad,
                 const T* __restrict__ dg, float* __restrict__ ws, int B,
                 int H, int W, int C, int Cx, FmaPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int cn = Cx + C;
  const int M = 4 * C;
  const int K = 9 * cn;
  const int mb = kTm * p.tm;
  const int cb = kTc * p.tc;
  const int R = p.rows;
  const int tw = p.tw;
  const FmaSmem L(p, mb, cb);

  const int n_mt = (M + mb - 1) / mb;
  const int n_ct = (cn + cb - 1) / cb;
  const int m0 = (blockIdx.x % n_mt) * mb;
  const int c0 = (blockIdx.x / n_mt % n_ct) * cb;
  const int chunk = blockIdx.x / (n_mt * n_ct);
  const int n_xt = (W + tw - 1) / tw;
  const int n_rg = (H + R - 1) / R;
  const long long n_units = (long long)B * n_rg * n_xt;
  const int u_begin = (int)(n_units * chunk / p.chunks);
  const int n_my = (int)(n_units * (chunk + 1) / p.chunks) - u_begin;

  const int nt = p.tm * p.tc;        // threads of a pixel group
  const int lt = threadIdx.x % nt;
  const int cg = lt % p.tc;
  const int rg = lt / p.tc;
  const int kg = threadIdx.x / nt;   // the pixel group

  auto unit_origin = [&](int u, int& b, int& y0, int& x0) {
    x0 = (u % n_xt) * tw;
    y0 = (u / n_xt % n_rg) * R;
    b = u / (n_xt * n_rg);
  };

  // unit u into ring slot s: dg's rows (16-byte copies where fp32 rows
  // are 16-byte aligned, W % 4 == 0, else element by element) and the
  // halo of the block's channels, x_pad's ring as given and h zero
  // outside the image, element by element at its padded column; zero
  // past the image, M and Cx + C
  const bool vec = sizeof(T) == 4 && W % 4 == 0;
  const int vw = vec ? 4 : 1;
  const int qd = tw / vw;
  const Walk w_dg(threadIdx.x, blockDim.x, qd, mb);
  const Walk w_h(threadIdx.x, blockDim.x, tw + 2, R + 2);
  auto fetch = [&](int u, int s) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    float* dgs = smem + (size_t)s * L.stage;
    float* hal = dgs + L.dgn;
    Walk w = w_dg;
    for (int i = threadIdx.x; i < R * mb * qd; i += blockDim.x, w.next()) {
      const int y = y0 + w.c;
      const int m = m0 + w.b;
      const int x = x0 + vw * w.a;
      const bool ok = y < H && m < M && x < W;
      const T* src = ok ? dg + ((size_t)(b * H + y) * M + m) * W + x : dg;
      float* dst = dgs + (w.c * mb + w.b) * L.ds + vw * w.a;
      if (vec)
        cp_async16(dst, src, ok ? 16 : 0);
      else
        stage_one(dst, src, ok);
    }
    w = w_h;
    for (int i = threadIdx.x; i < cb * (R + 2) * (tw + 2);
         i += blockDim.x, w.next()) {
      const int ch = c0 + w.c;
      const int py = y0 + w.b;   // padded row and column
      const int px = x0 + w.a;
      const T* src = dg;
      bool ok = false;
      if (ch < Cx) {
        ok = py < H + 2 && px < W + 2;
        if (ok)
          src = x_pad + ((size_t)(b * (H + 2) + py) * Cx + ch) * (W + 2) + px;
      } else if (ch < cn) {
        ok = py >= 1 && py <= H && px >= 1 && px <= W;
        if (ok)
          src = h_prev + ((size_t)(b * H + py - 1) * C + ch - Cx) * W + px - 1;
      }
      stage_one(hal + w.c * L.cs + w.b * L.hs + w.a, src, ok);
    }
  };

  float acc[kTm][kTc][9];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < kTc; ++j)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[i][j][t] = 0.0f;

  // this group's quads of unit u (row r, pixels 4 x4 .. 4 x4 + 3): kg,
  // kg + groups, ... in row order; pixels past the image read dg's zeros
  auto compute = [&](int s, int u) {
    int b, y0, x0;
    unit_origin(u, b, y0, x0);
    const float* dgs = smem + (size_t)s * L.stage;
    const float* hal = dgs + L.dgn;
    const int r_end = min(R, H - y0);
    const int nqx = (min(tw, W - x0) + 3) / 4;
    const int dr = p.groups / nqx;
    const int dq = p.groups % nqx;
    int r = kg / nqx;
    int x4 = kg % nqx;
    while (r < r_end) {
      float a[kTm][4];
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            dgs + (r * mb + rg + i * p.tm) * L.ds + 4 * x4);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kTc; ++j) {
        const float* hp = hal + (cg + j * p.tc) * L.cs + r * L.hs + 4 * x4;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4 lo = *reinterpret_cast<const float4*>(hp + dy * L.hs);
          const float4 hi =
              *reinterpret_cast<const float4*>(hp + dy * L.hs + 4);
          const float hv[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int i = 0; i < kTm; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[i][j][3 * dy + dx] =
                    fmaf(a[i][q], hv[q + dx], acc[i][j][3 * dy + dx]);
        }
      }
      r += dr;
      x4 += dq;
      if (x4 >= nqx) {
        x4 -= nqx;
        ++r;
      }
    }
  };

  // the ring: unit k waits for its copies, the slot freed by unit k - 1
  // takes unit k + stages - 1, then unit k is multiplied
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < n_my) fetch(u_begin + s, s);
    cp_async_commit();
  }
  for (int k = 0; k < n_my; ++k) {
    if (p.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int next = k + p.stages - 1;
    if (next < n_my) fetch(u_begin + next, next % p.stages);
    cp_async_commit();
    compute(k % p.stages, u_begin + k);
  }
  cp_async_wait<0>();
  __syncthreads();

  // groups 1 .. groups - 1 leave their tiles in shared memory, group 0
  // adds them in group order and writes the chunk's partial
  constexpr int E = kTm * kTc * 9;
  if (kg > 0) {
    float* red = smem + (size_t)(kg - 1) * E * nt + lt;
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTc; ++j)
#pragma unroll
        for (int t = 0; t < 9; ++t)
          red[((i * kTc + j) * 9 + t) * nt] = acc[i][j][t];
  }
  __syncthreads();
  if (kg > 0) return;
  for (int g = 1; g < p.groups; ++g) {
    const float* red = smem + (size_t)(g - 1) * E * nt + lt;
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTc; ++j)
#pragma unroll
        for (int t = 0; t < 9; ++t)
          acc[i][j][t] += red[((i * kTc + j) * 9 + t) * nt];
  }
  float* out = ws + (size_t)chunk * M * K;
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    const int m = m0 + rg + i * p.tm;
#pragma unroll
    for (int j = 0; j < kTc; ++j) {
      const int ch = c0 + cg + j * p.tc;
      if (m < M && ch < cn) {
#pragma unroll
        for (int t = 0; t < 9; ++t)
          out[(size_t)m * K + packed_col(t, ch, C, Cx)] = acc[i][j][t];
      }
    }
  }
}

// dwt[i] = sum over chunks c in order of ws[c][i], cast to dwt's dtype;
// eight chunks' loads in flight at a time, added in chunk order.
template <typename T>
__global__ void dwt_reduce_kernel(const float* __restrict__ ws,
                                  T* __restrict__ out, int n_chunks,
                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  int c = 0;
  for (; c + 8 <= n_chunks; c += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = ws[(size_t)(c + j) * n + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; c < n_chunks; ++c) s += ws[(size_t)c * n + i];
  out[i] = from_f<T>(s);
}

template <int WA, int WC>
cudaError_t launch_mma(const bf16* h_prev, const bf16* x_pad, const bf16* dg,
                       float* ws, int B, int H, int W, int C, int Cx,
                       const MmaPlan& p, cudaStream_t s) {
  const int mb = 16 * WA * p.wm;
  const int cb = 8 * WC * p.wc;
  const size_t smem = Smem(p, mb, cb).bytes();
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dwt_mma_kernel<WA, WC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)(4 * C / mb) * ((Cx + C) / cb) * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dwt_mma_kernel<WA, WC><<<(unsigned)blocks, 32 * p.wm * p.wc, smem, s>>>(
      h_prev, x_pad, dg, ws, B, H, W, C, Cx, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* h_prev, const void* x_pad, const void* dg,
                       float* ws, int B, int H, int W, int C, int Cx,
                       const FmaPlan& p, cudaStream_t s) {
  const int mb = kTm * p.tm;
  const int cb = kTc * p.tc;
  const size_t smem = FmaSmem(p, mb, cb).bytes(p.stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dwt_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((4 * C + mb - 1) / mb) *
                           ((Cx + C + cb - 1) / cb) * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dwt_tiled_kernel<T><<<(unsigned)blocks, p.tm * p.tc * p.groups, smem, s>>>(
      static_cast<const T*>(h_prev), static_cast<const T*>(x_pad),
      static_cast<const T*>(dg), ws, B, H, W, C, Cx, p);
  return cudaGetLastError();
}

}  // namespace

// h_prev (B, H, C, W), x_pad (B, H+2, Cx, W+2) or null when Cx == 0,
// dg (B, H, 4C, W) -> dwt (4C, 9(Cx+C)) in dg's dtype; ws holds
// ws_floats floats, at least chunks * 4C * 9(Cx+C). dtype: 0 = float32,
// 1 = bfloat16. The plan (weight_grad_plan), units of `rows` x `tw`
// pixels, a ring of `stages` units and `chunks` pixel chunks either way:
// mma = 1 the tensor-core loop (bfloat16, C, Cx and W multiples of 8) with
// warp tiles of 16 wa gate rows x 8 wc channels, wm x wcn warps; mma = 0
// the FMA loop with tm x tcn threads a pixel group and `groups` groups
// (at most 256 threads). Returns the first failing launch's cudaError_t, 0 on
// success; cudaErrorInvalidValue for a plan that does not fit the shapes.
extern "C" int rsis_weight_grad(const void* h_prev, const void* x_pad,
                                const void* dg, void* ws, long long ws_floats,
                                void* dwt, int B, int H, int W, int C, int Cx,
                                int dtype, int mma, int wa, int wc, int wm,
                                int wcn, int rows, int tw, int stages,
                                int chunks, int tm, int tcn, int groups,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cx < 0 ||
      (dtype != 0 && dtype != 1) || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int M = 4 * C;
  const int cn = Cx + C;
  const long long n = (long long)M * 9 * cn;
  if (ws_floats < n * chunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (mma) {
    if (dtype != 1 || C % 8 || Cx % 8 || W % 8 || wa < 1 || wa > 2 ||
        wc < 1 || wc > 2 || wm < 1 || wcn < 1 || wm * wcn > 8 ||
        M % (16 * wa * wm) || cn % (8 * wc * wcn) || rows < 1 || tw < 16 ||
        tw % 16 || (stages != 2 && stages != 3))
      return (int)cudaErrorInvalidValue;
    const MmaPlan p{wm, wcn, rows, tw, stages, chunks};
    using T = bf16;
    const T* hp = static_cast<const T*>(h_prev);
    const T* xp = static_cast<const T*>(x_pad);
    const T* gp = static_cast<const T*>(dg);
    if (wa == 1 && wc == 1)
      err = launch_mma<1, 1>(hp, xp, gp, w, B, H, W, C, Cx, p, s);
    else if (wa == 1)
      err = launch_mma<1, 2>(hp, xp, gp, w, B, H, W, C, Cx, p, s);
    else if (wc == 1)
      err = launch_mma<2, 1>(hp, xp, gp, w, B, H, W, C, Cx, p, s);
    else
      err = launch_mma<2, 2>(hp, xp, gp, w, B, H, W, C, Cx, p, s);
  } else {
    if (tm < 1 || tcn < 1 || groups < 1 || tm * tcn * groups > 256 ||
        rows < 1 || tw < 4 || tw % 4 || (stages != 2 && stages != 3))
      return (int)cudaErrorInvalidValue;
    const FmaPlan p{tm, tcn, groups, rows, tw, stages, chunks};
    if (dtype == 0)
      err = launch_fma<float>(h_prev, x_pad, dg, w, B, H, W, C, Cx, p, s);
    else
      err = launch_fma<bf16>(h_prev, x_pad, dg, w, B, H, W, C, Cx, p, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long rblocks = (n + threads - 1) / threads;
  if (dtype == 0)
    dwt_reduce_kernel<float><<<(unsigned)rblocks, threads, 0, s>>>(
        w, static_cast<float*>(dwt), chunks, n);
  else
    dwt_reduce_kernel<bf16><<<(unsigned)rblocks, threads, 0, s>>>(
        w, static_cast<bf16*>(dwt), chunks, n);
  return (int)cudaGetLastError();
}
