// Native RLE mask library (host C++) of rsis_tpu_torch: a copy of
// rsis_tpu/kernels/rle/rle.cpp.
//
// A fresh C++17 implementation of the run-length-encoded binary mask
// operations needed by COCO-style instance segmentation evaluation.
// Behavioural contract (column-major runs starting with background, the
// LEB128-style compressed string codec, crowd IoU semantics, polygon
// rasterisation geometry) follows the public COCO mask API as used by the
// reference pipeline (reference: src/coco/common/maskApi.h:16-60), but the
// implementation here is written from scratch around std::vector storage and
// a streaming two-run cursor, exported through a flat-buffer C ABI consumed
// by ctypes (rsis_tpu_torch/kernels/_binding.py).
//
// All masks are h*w column-major (Fortran order): runs walk down columns.
// counts[0] is always the number of leading background pixels (may be 0).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

using u32 = std::uint32_t;
using u64 = std::uint64_t;
using u8 = std::uint8_t;

// A view over one RLE-encoded mask: a span of run counts plus dims.
struct RleView {
  u64 h = 0, w = 0;
  const u32* cnts = nullptr;
  u64 m = 0;
};

// Streaming cursor over the runs of one mask. `value()` is the pixel value
// of the current run; `take(k)` consumes k pixels from it.
class RunCursor {
 public:
  explicit RunCursor(const RleView& r) : r_(r) {
    remaining_ = r_.m ? r_.cnts[0] : 0;
  }
  bool done() const { return idx_ >= r_.m || (remaining_ == 0 && idx_ + 1 >= r_.m); }
  u32 remaining() const { return remaining_; }
  bool value() const { return (idx_ & 1) != 0; }
  void advance_if_empty() {
    while (remaining_ == 0 && idx_ + 1 < r_.m) {
      ++idx_;
      remaining_ = r_.cnts[idx_];
    }
  }
  void take(u32 k) {
    remaining_ -= k;
    advance_if_empty();
  }
  bool exhausted() const { return remaining_ == 0 && idx_ + 1 >= r_.m; }

 private:
  RleView r_;
  u64 idx_ = 0;
  u32 remaining_ = 0;
};

std::vector<u32> encode_one(const u8* mask, u64 npix) {
  std::vector<u32> cnts;
  cnts.reserve(64);
  u8 cur = 0;  // runs always start with background
  u32 run = 0;
  for (u64 i = 0; i < npix; ++i) {
    u8 v = mask[i] ? 1 : 0;
    if (v != cur) {
      cnts.push_back(run);
      run = 0;
      cur = v;
    }
    ++run;
  }
  cnts.push_back(run);
  return cnts;
}

void decode_one(const RleView& r, u8* out) {
  u8 v = 0;
  u64 pos = 0;
  for (u64 j = 0; j < r.m; ++j) {
    std::memset(out + pos, v, r.cnts[j]);
    pos += r.cnts[j];
    v = !v;
  }
}

u64 area_one(const RleView& r) {
  u64 a = 0;
  for (u64 j = 1; j < r.m; j += 2) a += r.cnts[j];
  return a;
}

// Merge two run streams with a boolean op (intersect / union), producing a
// fresh canonical run list (starting with background, no zero-length interior
// runs except a possible leading zero).
std::vector<u32> merge_two(const RleView& a, const RleView& b, bool intersect) {
  std::vector<u32> out;
  RunCursor ca(a), cb(b);
  ca.advance_if_empty();
  cb.advance_if_empty();
  bool cur = false;
  u64 run = 0;
  u64 total = a.h * a.w;
  u64 consumed = 0;
  while (consumed < total) {
    u32 step = std::min(ca.remaining(), cb.remaining());
    if (step == 0) break;  // malformed input; bail
    bool v = intersect ? (ca.value() && cb.value()) : (ca.value() || cb.value());
    if (v != cur) {
      out.push_back(static_cast<u32>(run));
      run = 0;
      cur = v;
    }
    run += step;
    consumed += step;
    ca.take(step);
    cb.take(step);
  }
  out.push_back(static_cast<u32>(run));
  return out;
}

// Intersection & union pixel counts between two run streams in one pass.
void overlap_counts(const RleView& a, const RleView& b, u64* inter, u64* uni) {
  RunCursor ca(a), cb(b);
  ca.advance_if_empty();
  cb.advance_if_empty();
  u64 i = 0, u = 0;
  u64 total = a.h * a.w;
  u64 consumed = 0;
  while (consumed < total) {
    u32 step = std::min(ca.remaining(), cb.remaining());
    if (step == 0) break;
    bool va = ca.value(), vb = cb.value();
    if (va || vb) {
      u += step;
      if (va && vb) i += step;
    }
    consumed += step;
    ca.take(step);
    cb.take(step);
  }
  *inter = i;
  *uni = u;
}

void bbox_one(const RleView& r, double* bb) {
  // Output [x, y, w, h] like the COCO contract.
  u64 h = r.h, w = r.w;
  if (r.m == 0 || h * w == 0) {
    bb[0] = bb[1] = bb[2] = bb[3] = 0;
    return;
  }
  u64 xs = w, xe = 0, ys = h, ye = 0;
  u64 pos = 0;
  bool any = false;
  for (u64 j = 0; j < r.m; ++j) {
    u64 c = r.cnts[j];
    if ((j & 1) && c > 0) {
      any = true;
      u64 start = pos, end = pos + c - 1;
      u64 xs_j = start / h, xe_j = end / h;
      xs = std::min(xs, xs_j);
      xe = std::max(xe, xe_j);
      if (xs_j == xe_j) {
        // run stays inside one column
        ys = std::min(ys, start % h);
        ye = std::max(ye, end % h);
      } else {
        // spans column boundary: touches full height
        ys = 0;
        ye = h - 1;
      }
    }
    pos += c;
  }
  if (!any) {
    bb[0] = bb[1] = bb[2] = bb[3] = 0;
    return;
  }
  bb[0] = static_cast<double>(xs);
  bb[1] = static_cast<double>(ys);
  bb[2] = static_cast<double>(xe - xs + 1);
  bb[3] = static_cast<double>(ye - ys + 1);
}

double bb_iou_pair(const double* d, const double* g, bool crowd) {
  double da = d[2] * d[3], ga = g[2] * g[3];
  double x0 = std::max(d[0], g[0]);
  double x1 = std::min(d[0] + d[2], g[0] + g[2]);
  double y0 = std::max(d[1], g[1]);
  double y1 = std::min(d[1] + d[3], g[1] + g[3]);
  double iw = std::max(0.0, x1 - x0), ih = std::max(0.0, y1 - y0);
  double inter = iw * ih;
  double uni = crowd ? da : (da + ga - inter);
  if (uni <= 0) return 0.0;
  return inter / uni;
}

}  // namespace

extern "C" {

// ---- encode ------------------------------------------------------------
// masks: n masks, each h*w bytes, column-major, contiguous.
// out_cnts: caller buffer of n*(h*w+1) u32 (stride h*w+1 per mask).
// out_m: per-mask run counts.
void rsis_rle_encode(const u8* masks, u64 h, u64 w, u64 n, u32* out_cnts,
                     u64* out_m) {
  u64 npix = h * w;
  u64 stride = npix + 1;
  for (u64 i = 0; i < n; ++i) {
    auto cnts = encode_one(masks + i * npix, npix);
    std::copy(cnts.begin(), cnts.end(), out_cnts + i * stride);
    out_m[i] = cnts.size();
  }
}

// ---- decode ------------------------------------------------------------
// cnts: concatenated run lists; offs[i] is start of mask i, ms[i] its length.
void rsis_rle_decode(const u32* cnts, const u64* offs, const u64* ms, u64 h,
                     u64 w, u64 n, u8* out_masks) {
  u64 npix = h * w;
  for (u64 i = 0; i < n; ++i) {
    RleView r{h, w, cnts + offs[i], ms[i]};
    decode_one(r, out_masks + i * npix);
  }
}

// ---- area --------------------------------------------------------------
void rsis_rle_area(const u32* cnts, const u64* offs, const u64* ms, u64 n,
                   u32* out_area) {
  for (u64 i = 0; i < n; ++i) {
    RleView r{0, 0, cnts + offs[i], ms[i]};
    out_area[i] = static_cast<u32>(area_one(r));
  }
}

// ---- merge -------------------------------------------------------------
// Folds n masks into one via union (intersect=0) or intersection (=1).
// out_cnts must hold h*w+1 entries; returns run count via out_m.
void rsis_rle_merge(const u32* cnts, const u64* offs, const u64* ms, u64 n,
                    u64 h, u64 w, int intersect, u32* out_cnts, u64* out_m) {
  if (n == 0) {
    *out_m = 0;
    return;
  }
  std::vector<u32> acc(cnts + offs[0], cnts + offs[0] + ms[0]);
  for (u64 i = 1; i < n; ++i) {
    RleView a{h, w, acc.data(), acc.size()};
    RleView b{h, w, cnts + offs[i], ms[i]};
    acc = merge_two(a, b, intersect != 0);
  }
  std::copy(acc.begin(), acc.end(), out_cnts);
  *out_m = acc.size();
}

// ---- mask IoU (crowd semantics) -----------------------------------------
// dt: m masks, gt: n masks. iscrowd: n flags (may be null).
// out: column-major [n, m] like the COCO contract (o[g*m+d]).
// Mismatched dims yield -1 for that pair.
void rsis_rle_iou(const u32* dt_cnts, const u64* dt_offs, const u64* dt_ms,
                  const u64* dt_hw, u64 m, const u32* gt_cnts,
                  const u64* gt_offs, const u64* gt_ms, const u64* gt_hw,
                  u64 n, const u8* iscrowd, double* out) {
  for (u64 g = 0; g < n; ++g) {
    for (u64 d = 0; d < m; ++d) {
      u64 dh = dt_hw[2 * d], dw = dt_hw[2 * d + 1];
      u64 gh = gt_hw[2 * g], gw = gt_hw[2 * g + 1];
      if (dh != gh || dw != gw) {
        out[g * m + d] = -1.0;
        continue;
      }
      RleView rd{dh, dw, dt_cnts + dt_offs[d], dt_ms[d]};
      RleView rg{gh, gw, gt_cnts + gt_offs[g], gt_ms[g]};
      u64 inter = 0, uni = 0;
      overlap_counts(rd, rg, &inter, &uni);
      bool crowd = iscrowd && iscrowd[g];
      double denom;
      if (inter == 0) {
        denom = 1.0;
      } else if (crowd) {
        denom = static_cast<double>(area_one(rd));
      } else {
        denom = static_cast<double>(uni);
      }
      out[g * m + d] = denom > 0 ? static_cast<double>(inter) / denom : 0.0;
    }
  }
}

// ---- bbox --------------------------------------------------------------
void rsis_rle_to_bbox(const u32* cnts, const u64* offs, const u64* ms,
                      const u64* hw, u64 n, double* out_bb) {
  for (u64 i = 0; i < n; ++i) {
    RleView r{hw[2 * i], hw[2 * i + 1], cnts + offs[i], ms[i]};
    bbox_one(r, out_bb + 4 * i);
  }
}

void rsis_bb_iou(const double* dt, const double* gt, u64 m, u64 n,
                 const u8* iscrowd, double* out) {
  for (u64 g = 0; g < n; ++g)
    for (u64 d = 0; d < m; ++d)
      out[g * m + d] =
          bb_iou_pair(dt + 4 * d, gt + 4 * g, iscrowd && iscrowd[g]);
}

// ---- bbox -> RLE ---------------------------------------------------------
// bb rows are [x, y, w, h]; produces an axis-aligned rectangle mask.
void rsis_rle_from_bbox(const double* bb, u64 h, u64 w, u64 n, u32* out_cnts,
                        u64* out_m) {
  u64 stride = h * w + 1;
  std::vector<u8> mask(h * w);
  for (u64 i = 0; i < n; ++i) {
    std::fill(mask.begin(), mask.end(), 0);
    double xs = bb[4 * i], ys = bb[4 * i + 1];
    double xe = xs + bb[4 * i + 2], ye = ys + bb[4 * i + 3];
    u64 x0 = static_cast<u64>(std::max(0.0, std::floor(xs)));
    u64 y0 = static_cast<u64>(std::max(0.0, std::floor(ys)));
    u64 x1 = static_cast<u64>(std::min<double>(w, std::ceil(xe)));
    u64 y1 = static_cast<u64>(std::min<double>(h, std::ceil(ye)));
    for (u64 x = x0; x < x1; ++x)
      for (u64 y = y0; y < y1; ++y) mask[x * h + y] = 1;
    auto cnts = encode_one(mask.data(), h * w);
    std::copy(cnts.begin(), cnts.end(), out_cnts + i * stride);
    out_m[i] = cnts.size();
  }
}

// ---- polygon -> RLE ------------------------------------------------------
// xy: k (x, y) vertex pairs. Rasterises via the COCO geometry convention:
// vertices are scaled 5x onto a fine grid, edges are walked point-by-point,
// every column-boundary crossing of the walk is recorded, and the mask is the
// even-odd parity fill of the sorted crossing positions (column-major order).
void rsis_rle_from_poly(const double* xy, u64 k, u64 h, u64 w, u32* out_cnts,
                        u64* out_m) {
  constexpr long long SCALE = 5;
  const double scl = static_cast<double>(SCALE);

  // Upscale and round vertices onto the fine grid; close the loop.
  std::vector<long long> vx(k + 1), vy(k + 1);
  for (u64 j = 0; j < k; ++j) {
    vx[j] = llround(scl * xy[2 * j] + 0.5);
    vy[j] = llround(scl * xy[2 * j + 1] + 0.5);
  }
  vx[k] = vx[0];
  vy[k] = vy[0];

  // Walk every edge one fine-grid step at a time along its major axis.
  std::vector<long long> px, py;
  for (u64 j = 0; j < k; ++j) {
    long long xs = vx[j], xe = vx[j + 1], ys = vy[j], ye = vy[j + 1];
    long long dx = std::llabs(xe - xs), dy = std::llabs(ye - ys);
    bool x_major = dx >= dy;
    bool flip = x_major ? (dx > 0 && xs > xe) : (dy > 0 && ys > ye);
    if (flip) {
      std::swap(xs, xe);
      std::swap(ys, ye);
    }
    long long steps = x_major ? dx : dy;
    double slope = (steps == 0) ? 0.0
                                : (x_major ? static_cast<double>(ye - ys) / dx
                                           : static_cast<double>(xe - xs) / dy);
    for (long long d = 0; d <= steps; ++d) {
      long long t = flip ? steps - d : d;
      if (x_major) {
        px.push_back(xs + t);
        py.push_back(llround(ys + slope * t));
      } else {
        py.push_back(ys + t);
        px.push_back(llround(xs + slope * t));
      }
    }
  }

  // Record a parity toggle at every pixel-column crossing of the walk.
  std::vector<u64> crossings;
  for (size_t j = 1; j < px.size(); ++j) {
    if (px[j] == px[j - 1]) continue;
    double xd = static_cast<double>(std::min(px[j], px[j - 1]));
    xd = (xd + 0.5) / scl - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > static_cast<double>(w) - 1)
      continue;  // crossing not on a pixel column boundary
    double yd = static_cast<double>(std::min(py[j], py[j - 1]));
    yd = (yd + 0.5) / scl - 0.5;
    yd = std::ceil(std::clamp(yd, 0.0, static_cast<double>(h)));
    crossings.push_back(static_cast<u64>(xd) * h + static_cast<u64>(yd));
  }
  std::sort(crossings.begin(), crossings.end());

  // Even-odd parity fill over flat column-major positions, then canonicalise
  // by decoding to a mask and re-encoding.
  u64 npix = h * w;
  std::vector<u8> mask(npix, 0);
  u64 prev = 0;
  bool inside = false;
  for (u64 c : crossings) {
    u64 end = std::min(c, npix);
    if (inside && end > prev) std::memset(mask.data() + prev, 1, end - prev);
    prev = end;
    inside = !inside;
  }
  if (inside && npix > prev) std::memset(mask.data() + prev, 1, npix - prev);
  auto canonical = encode_one(mask.data(), npix);
  std::copy(canonical.begin(), canonical.end(), out_cnts);
  *out_m = canonical.size();
}

// ---- NMS -----------------------------------------------------------------
void rsis_rle_nms(const u32* cnts, const u64* offs, const u64* ms,
                  const u64* hw, u64 n, double thr, u32* keep) {
  for (u64 i = 0; i < n; ++i) keep[i] = 1;
  for (u64 i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (u64 j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      RleView a{hw[2 * i], hw[2 * i + 1], cnts + offs[i], ms[i]};
      RleView b{hw[2 * j], hw[2 * j + 1], cnts + offs[j], ms[j]};
      u64 inter = 0, uni = 0;
      overlap_counts(a, b, &inter, &uni);
      double iou = (inter == 0) ? 0.0
                                : static_cast<double>(inter) /
                                      static_cast<double>(uni ? uni : 1);
      if (iou > thr) keep[j] = 0;
    }
  }
}

void rsis_bb_nms(const double* bb, u64 n, double thr, u32* keep) {
  for (u64 i = 0; i < n; ++i) keep[i] = 1;
  for (u64 i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (u64 j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      if (bb_iou_pair(bb + 4 * i, bb + 4 * j, false) > thr) keep[j] = 0;
    }
  }
}

// ---- compressed string codec ----------------------------------------------
// 6-bit varint delta codec: counts[i] stored as-is for the first three runs
// and as a delta vs counts[i-2] from i==3 onward (pycocotools convention —
// the asymmetric i>2 start index is required for byte compatibility with
// every COCO JSON in the wild). Each value is split into 5-bit groups (low
// first), chars offset by 48, bit 0x20 as the continuation flag. This is
// the on-disk/JSON interchange format.
u64 rsis_rle_to_string(const u32* cnts, u64 m, char* out) {
  u64 p = 0;
  for (u64 i = 0; i < m; ++i) {
    long long x = static_cast<long long>(cnts[i]);
    if (i > 2) x -= static_cast<long long>(cnts[i - 2]);
    bool more = true;
    while (more) {
      long long c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      c += 48;
      out[p++] = static_cast<char>(c);
    }
  }
  out[p] = 0;
  return p;
}

u64 rsis_rle_from_string(const char* s, u64 /*h*/, u64 /*w*/, u32* out_cnts) {
  u64 m = 0, p = 0;
  while (s[p]) {
    long long x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      long long c = static_cast<long long>(s[p]) - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++p;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += static_cast<long long>(out_cnts[m - 2]);
    out_cnts[m++] = static_cast<u32>(x);
  }
  return m;
}

// ---------------------------------------------------------------------------
// Packed-target packing: instance map -> (max_seq, h*w+3) uint8 wire rows.
//
// Native twin of data/base.py sequence_from_masks (reference semantics:
// src/dataloader/dataset.py:86-146): split the instance map into binary
// per-instance masks, sort by descending pixel area, truncate/pad to
// max_seq slots, append [class, sw_mask, sw_class] columns; the <eos> slot
// after the last real instance gets class weight 1. The per-instance class
// is the MINIMUM seg value over the instance's pixels (np.unique()[0]).
// Equal areas tie-break by ascending instance id (numpy's argsort order
// for ties is unspecified; any order is a valid target permutation).
//
// One O(h*w) pass for areas/classes + one O(h*w) scatter into the output
// rows replaces the numpy path's per-instance full-image scans
// (~57 ms/sample -> sub-ms at 256x512, the host-side bottleneck of the
// training input pipeline).
//
// out must be zero-initialised, (max_seq, h*w+3) row-major uint8.
// Returns the number of real instances written (before truncation).
u64 rsis_pack_target(const int32_t* ins, const int32_t* seg, u64 h, u64 w,
                     u64 max_seq, u8* out) {
  const u64 hw = h * w;
  int32_t max_id = 0;
  for (u64 p = 0; p < hw; ++p)
    if (ins[p] > max_id) max_id = ins[p];
  if (max_id <= 0) {
    if (max_seq > 0) out[0 * (hw + 3) + hw + 2] = 1;  // <eos> slot
    return 0;
  }
  std::vector<u64> area(static_cast<u64>(max_id) + 1, 0);
  std::vector<int32_t> cls(static_cast<u64>(max_id) + 1,
                           std::numeric_limits<int32_t>::max());
  for (u64 p = 0; p < hw; ++p) {
    int32_t id = ins[p];
    if (id > 0) {
      ++area[id];
      if (seg[p] < cls[id]) cls[id] = seg[p];
    }
  }
  std::vector<int32_t> ids;
  ids.reserve(max_id);
  for (int32_t id = 1; id <= max_id; ++id)
    if (area[id] > 0) ids.push_back(id);
  std::sort(ids.begin(), ids.end(), [&](int32_t a, int32_t b) {
    if (area[a] != area[b]) return area[a] > area[b];
    return a < b;
  });
  const u64 total = ids.size();
  std::vector<int64_t> slot(static_cast<u64>(max_id) + 1, -1);
  const u64 kept = total < max_seq ? total : max_seq;
  for (u64 r = 0; r < kept; ++r) slot[ids[r]] = static_cast<int64_t>(r);
  const u64 row = hw + 3;
  for (u64 p = 0; p < hw; ++p) {
    int32_t id = ins[p];
    if (id > 0) {
      int64_t r = slot[id];
      if (r >= 0) out[static_cast<u64>(r) * row + p] = 1;
    }
  }
  for (u64 r = 0; r < kept; ++r) {
    u8* tail = out + r * row + hw;
    int32_t c = cls[ids[r]];
    tail[0] = static_cast<u8>(c < 0 ? 0 : (c > 255 ? 255 : c));
    tail[1] = 1;
    tail[2] = 1;
  }
  if (max_seq > total) out[total * row + hw + 2] = 1;  // <eos> slot
  return total;
}

}  // extern "C"
