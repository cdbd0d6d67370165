"""The host-side plan of K2 (the fused mask head),
``ops/mask_head.mask_head_plan``, the kernel's order of work that it sizes,
and the NCHW entry and its route in the plain decoder.

No card here: the plan is checked for what ``csrc/mask_head.cu`` takes
(column width against W, the strides and the address; at most 8 warps;
every output pixel written by exactly one thread) at the head's shapes and
at ``chip_smoke.K2_EDGE_GEOMS`` in both layouts; a numpy mirror of the
kernel (each thread's V columns loaded a channel chunk at a time, the row
walk with one halo row above and below, the two output-row pairs kept
over rows, the column stage from the neighbouring threads with zeros at a
block's ends, the halo threads of a strip that do not store) is held in
fp32 against ``mask_head_ref`` and JAX's ``mask_head_fused`` within 1e-4;
the NCHW wrapper on CPU tensors against JAX's ``mask_head_pallas_t`` in
interpret mode; and the plain decoder's head route (K2 under no_grad with
a 3x3 head, else the upsample and ``F.conv2d``)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.ops.mask_head import mask_head_fused
from rsis_tpu.ops.pallas_mask_head import mask_head_pallas_t
from rsis_tpu_torch.models import decoder as dec_mod
from rsis_tpu_torch.models.decoder import RSISDecoder, skip_widths
from rsis_tpu_torch.ops import mask_head as mh
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ATOL = 1e-4
# (B, H, C, W) of the head at 512x1024 (B = 32 and 4) and of the train
# step at 256x512 (B = 32 and 8), hidden 128
HEAD_SHAPES = [(32, 256, 8, 512), (4, 256, 8, 512), (32, 128, 8, 256),
               (8, 128, 8, 256)]
LAYOUTS = ("rowmajor", "nchw")


def _strides(shape, layout):
    """(batch, channel, row) strides in elements of a contiguous input."""
    _, h, c, w = shape
    return (h * c * w, w, c * w) if layout == "rowmajor" else (
        c * h * w, h * w, w)


def _first_column(plan, strip, thread, w):
    """The kernel's first input column of one thread of a strip: strips
    ``col_step`` apart, each starting one thread's columns early."""
    start = strip * plan.col_step(w) - plan.v if plan.strips(w) > 1 else 0
    return start + thread * plan.v


def _stores(plan, strip, thread, w):
    """Whether the thread writes its columns' outputs: in the image and,
    where a row has several strips, not a strip's first or last thread."""
    n0 = _first_column(plan, strip, thread, w)
    halo = plan.strips(w) > 1 and thread in (0, plan.threads - 1)
    return 0 <= n0 < w and not halo


def _coverage(plan, shape):
    """Per input column and per input row, how many threads store it."""
    b, h, _, w = shape
    cols = np.zeros(w, np.int64)
    for strip in range(plan.strips(w)):
        for t in range(plan.threads):
            if _stores(plan, strip, t, w):
                n0 = _first_column(plan, strip, t, w)
                cols[n0:n0 + plan.v] += 1
    rows = np.zeros(h, np.int64)
    for r0 in range(0, h, plan.rows):
        rows[r0:min(r0 + plan.rows, h)] += 1
    return cols, rows


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HEAD_SHAPES + chip_smoke.K2_EDGE_GEOMS)
def test_plan_covers_every_output_once(shape, dtype, layout):
    b, h, c, w = shape
    strides = _strides(shape, layout)
    plan = mh.mask_head_plan(b, h, c, w, dtype, strides)
    assert plan.v in mh.HEAD_VECTORS and w % plan.v == 0
    assert all(s % plan.v == 0 for s in strides)
    assert 1 <= plan.warps <= mh.HEAD_MAX_WARPS and 1 <= plan.rows <= h
    cols, rows = _coverage(plan, shape)
    # each thread stores 2v columns of the two output rows of each of its
    # rows: an input column or row stored once is its outputs written once
    assert (cols == 1).all() and (rows == 1).all()
    assert plan.blocks(b, h, w) == b * -(-h // plan.rows) * plan.strips(w)


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_shapes_take_wide_loads(shape):
    """The head's shapes: 4 columns a thread (8-byte bf16 loads, 16-byte
    fp32), whole rows a block, enough warps to fill the SMs."""
    b, h, c, w = shape
    for layout in LAYOUTS:
        plan = mh.mask_head_plan(b, h, c, w, torch.bfloat16,
                                 _strides(shape, layout))
        assert plan.v == 4 and plan.strips(w) == 1
        assert plan.warps * 32 * plan.v == w
        assert plan.blocks(b, h, w) * plan.warps >= mh.HEAD_WARP_TARGET
    # rows shrink at small B
    big = mh.mask_head_plan(32, 256, 8, 512, torch.bfloat16,
                            _strides((32, 256, 8, 512), "nchw"))
    small = mh.mask_head_plan(4, 256, 8, 512, torch.bfloat16,
                              _strides((4, 256, 8, 512), "nchw"))
    assert small.rows < big.rows


def test_edge_shapes_cover_every_choice():
    plans = [(g, mh.mask_head_plan(*g, torch.bfloat16,
                                   _strides(g, "rowmajor")))
             for g in chip_smoke.K2_EDGE_GEOMS]
    assert {p.v for _, p in plans} == set(mh.HEAD_VECTORS)
    assert any(h == 1 and w == 1 for (_, h, _, w), _ in plans)
    assert any(w % 2 for (*_, w), _ in plans)
    assert any(w % (32 * p.v) for (*_, w), p in plans)
    assert any(h % p.rows for (_, h, _, _), p in plans)
    assert any(p.strips(w) > 1 for (*_, w), p in plans)
    assert {p.warps > 1 for _, p in plans} == {False, True}
    assert {3, 16} <= {c for (_, _, c, _), _ in plans}
    assert any(b == 1 for (b, *_), _ in plans)


@pytest.mark.parametrize("w,strides,align,dtype,v", [
    (512, (4096, 512, 4096), 16, torch.bfloat16, 4),
    (70, (560, 70, 560), 16, torch.bfloat16, 2),      # W % 4 == 2
    (7, (56, 7, 56), 16, torch.float32, 1),           # odd W
    (512, (4096, 512, 4096), 8, torch.float32, 2),    # 8-byte address
    (512, (4096, 512, 4096), 4, torch.bfloat16, 2),
    (512, (4097, 512, 4096), 16, torch.bfloat16, 1),  # odd batch stride
])
def test_column_width(w, strides, align, dtype, v):
    assert mh.head_vector(w, dtype, strides, align) == v


# ---- the numpy mirror of the kernel -------------------------------------

def _mirror(flat, strides, weight, bias, shape, plan):
    """csrc/mask_head.cu in numpy (fp32), block by block with a block's
    threads as one vector: returns the (B, 2H, 2W) output and how many
    times each output was written."""
    b, h, c, w = shape
    sb, sc, sr = strides
    v, chunk = plan.v, 8
    n_chunks = -(-c // chunk)
    # the block's tap weights, [chunk][tap][j], zero past C
    kw = np.zeros((n_chunks * chunk, 9), np.float32)
    kw[:c] = weight.reshape(c, 9)
    kw = kw.reshape(n_chunks, chunk, 9).transpose(0, 2, 1)
    out = np.zeros((b, 2 * h, 2 * w), np.float32)
    count = np.zeros((b, 2 * h, 2 * w), np.int64)
    hden, wden = np.float32(2 * h - 1), np.float32(2 * w - 1)
    f32 = np.float32
    for bi in range(b):
        for r0 in range(0, h, plan.rows):
            m_last = min(r0 + plan.rows, h) - 1
            for strip in range(plan.strips(w)):
                n0 = np.array([_first_column(plan, strip, t, w)
                               for t in range(plan.threads)])
                col = n0[:, None] + np.arange(v)            # (threads, v)
                col_in = (n0 >= 0) & (n0 < w)
                owner = np.array([_stores(plan, strip, t, w)
                                  for t in range(plan.threads)])
                ext = n0[:, None] + np.arange(v + 1)
                a_w = np.where((ext >= 0) & (ext < w), ext / wden,
                               0).astype(f32)               # a[n0 + i]
                ext = ext - 1
                d_w = np.where((ext >= 0) & (ext < w), (w - 1 - ext) / wden,
                               0).astype(f32)               # d[n0 - 1 + i]
                p_acc = np.zeros((2, 3) + col.shape, f32)
                q_acc = np.zeros_like(p_acc)
                for r in range(r0 - 1, m_last + 2):
                    n_acc = np.zeros_like(p_acc)
                    if 0 <= r < h:
                        z = np.zeros((9,) + col.shape, f32)
                        for ci in range(n_chunks):
                            for j in range(chunk):
                                ch = ci * chunk + j
                                x = np.zeros(col.shape, f32)
                                if ch < c:
                                    idx = bi * sb + ch * sc + r * sr + col
                                    x[col_in] = flat[idx[col_in]]
                                z += kw[ci, :, j, None, None] * x
                        a1 = f32((r + 1) / hden) if r + 1 < h else f32(0)
                        ar = f32(r / hden)
                        br = f32(1) - ar
                        dr = f32((h - 1 - r) / hden)
                        cr = f32(1) - dr
                        dm = f32((h - r) / hden) if r >= 1 else f32(0)
                        z0, z1, z2 = z[0:3], z[3:6], z[6:9]
                        if r - 1 >= r0:
                            p_acc[0] += dm * z2
                            p_acc[1] += dm * z1 + br * z2
                        if r >= r0:
                            q_acc[0] += dm * z0 + br * z1 + cr * z2
                            q_acc[1] += br * z0 + cr * z1 + a1 * z2
                        if r + 1 <= m_last:
                            n_acc[0] = cr * z0 + a1 * z1
                            n_acc[1] = a1 * z0
                    if r - 1 >= r0:
                        _finish(p_acc, r - 1, a_w, d_w, bias, owner, n0,
                                out[bi], count[bi], w)
                    p_acc, q_acc = q_acc, n_acc
    return out, count


def _finish(y, m, a_w, d_w, bias, owner, n0, out, count, w):
    """The column stage of the pair m: each thread's neighbours' dx sums
    (zero at the block's ends), both output rows, stored by the owners."""
    v = y.shape[-1]
    zero = np.zeros((2, 3, 1, v), np.float32)
    left = np.concatenate([zero, y[:, :, :-1]], axis=2)[..., v - 1]
    right = np.concatenate([y[:, :, 1:], zero], axis=2)[..., 0]
    # columns n - 1 and n + 1 of each thread's v columns
    ym = np.concatenate([left[..., None], y[..., :-1]], axis=-1)
    yp = np.concatenate([y[..., 1:], right[..., None]], axis=-1)
    a, bb = a_w[:, :v], 1 - a_w[:, :v]
    dm, cm = d_w[:, :v], 1 - d_w[:, :v]
    d, c = d_w[:, 1:], 1 - d_w[:, 1:]
    ap, bp = a_w[:, 1:], 1 - a_w[:, 1:]
    for p in range(2):
        y0, y1, y2 = y[p]
        even = (bias + cm * ym[p, 0] + dm * y0 + a * ym[p, 1] + bb * y1
                + c * y2 + d * yp[p, 2])
        odd = (bias + a * ym[p, 0] + bb * y0 + c * y1 + d * yp[p, 1]
               + ap * y2 + bp * yp[p, 2])
        both = np.stack([even, odd], axis=-1).reshape(len(n0), 2 * v)
        for t in np.flatnonzero(owner):
            out[2 * m + p, 2 * n0[t]:2 * n0[t] + 2 * v] = both[t]
            count[2 * m + p, 2 * n0[t]:2 * n0[t] + 2 * v] += 1


MIRROR_CASES = [
    # (shape, plan or None for mask_head_plan's)
    ((1, 1, 8, 1), None),
    ((2, 5, 3, 7), None),
    ((2, 13, 8, 70), None),
    ((3, 9, 16, 200), None),
    ((2, 33, 5, 36), None),
    ((1, 6, 8, 1100), None),                         # halo strips
    ((2, 9, 8, 200), mh.MaskHeadPlan(4, 4, 1)),      # halo strips, R = 4
    ((1, 11, 8, 96), mh.MaskHeadPlan(2, 3, 2)),      # two warps, R = 3
    ((2, 7, 12, 40), mh.MaskHeadPlan(4, 2, 2)),      # an empty warp
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,plan", MIRROR_CASES)
def test_mirror_matches_plain_and_jax(shape, plan, layout):
    b, h, c, w = shape
    rng = np.random.default_rng(sum(shape))
    hs = rng.normal(size=(b, h, c, w)).astype(np.float32)
    weight = (rng.normal(size=(1, c, 3, 3)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    x = hs if layout == "rowmajor" else hs.transpose(0, 2, 1, 3)
    strides = _strides(shape, layout)
    plan = plan or mh.mask_head_plan(b, h, c, w, torch.float32, strides)
    got, count = _mirror(np.ascontiguousarray(x).ravel(), strides, weight,
                         bias[0], shape, plan)
    assert (count == 1).all()
    want = mh.mask_head_ref(torch.from_numpy(hs), torch.from_numpy(weight),
                            torch.from_numpy(bias))[..., 0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    jax_want = mask_head_fused(jnp.moveaxis(jnp.asarray(hs), 2, -1),
                               jnp.asarray(weight.transpose(2, 3, 1, 0)),
                               jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(jax_want)[..., 0], atol=ATOL)


# ---- the NCHW entry ------------------------------------------------------

def test_nchw_matches_pallas_t():
    """The (B, H, C, W) shape of test_pallas_mask_head.py's planes-major
    entry test, given to both as (B, C, H, W)."""
    b, h, c, w = 2, 48, 4, 8
    rng = np.random.default_rng(0)
    ht = rng.normal(size=(b, c, h, w)).astype(np.float32)
    k = rng.normal(size=(3, 3, c, 1)).astype(np.float32)   # HWIO
    bias = rng.normal(size=(1,)).astype(np.float32)
    launches = mh.mask_head_fused_kernel.launches
    got = mh.mask_head_nchw_kernel(
        torch.from_numpy(ht), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias))
    assert mh.mask_head_fused_kernel.launches == launches  # CPU: no kernel
    assert tuple(got.shape) == (b, 1, 2 * h, 2 * w)
    want = mask_head_pallas_t(jnp.asarray(ht), jnp.asarray(k),
                              jnp.asarray(bias), interpret=True)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want)[..., 0],
                               atol=ATOL)


def test_nchw_is_the_rowmajor_head():
    rng = np.random.default_rng(5)
    hs = torch.from_numpy(rng.normal(size=(2, 6, 4, 10)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(1, 4, 3, 3)).astype(
        np.float32))
    bias = torch.zeros(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = hs.to(dtype)
        a = mh.mask_head_nchw_kernel(x.transpose(1, 2).contiguous(), weight,
                                     bias)
        b = mh.mask_head_fused_kernel(x, weight, bias)
        assert a.dtype == dtype
        assert torch.equal(a[:, 0], b[..., 0])


def test_nchw_rejects_other_devices():
    ht = torch.empty(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError):
        mh.mask_head_nchw_kernel(ht, torch.empty(1, 2, 3, 3, device="meta"),
                                 torch.empty(1, device="meta"))
    with pytest.raises(ValueError):
        mh.mask_head_nchw_kernel(torch.zeros(1, 2, 3, 4),
                                 torch.zeros(1, 3, 3, 3), torch.zeros(1))


# ---- the plain decoder's head route ---------------------------------------

def _decoder_case(kernel_size=3, seed=0):
    torch.manual_seed(seed)
    dec = RSISDecoder(hidden_size=16, num_classes=4, kernel_size=kernel_size,
                      skip_mode="mul").eval()
    sizes = [(2, 4), (4, 8), (8, 16), (16, 32), (32, 64)]
    skips = [torch.randn(2, c, *hw) for c, hw in zip(skip_widths(16), sizes)]
    return dec, skips


@pytest.fixture
def record(monkeypatch):
    calls = []
    real = dec_mod.mask_head_nchw_kernel

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)
    monkeypatch.setattr(dec_mod, "mask_head_nchw_kernel", spy)
    return calls


def test_decoder_head_takes_k2_without_grad(record):
    dec, skips = _decoder_case()
    with torch.no_grad():
        (got, cls, stop), carry = dec(skips)
        assert record == [(2, 1, 32, 64)]
        # plain=True: the upsample and F.conv2d (the cells are K8's plain
        # version on the CPU either way)
        (want, cls_p, stop_p), carry_p = dec(skips, plain=True)
        assert len(record) == 1
        # a second step through the carried state
        (got2, *_), _ = dec(skips, carry)
        (want2, *_), _ = dec(skips, carry_p, plain=True)
    assert got.shape == want.shape == (2, 1, 64, 128)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got2, want2, atol=1e-5, rtol=0)
    assert torch.equal(cls, cls_p) and torch.equal(stop, stop_p)


def test_decoder_head_keeps_the_upsample_otherwise(record):
    dec, skips = _decoder_case()
    dec(skips)                                   # grad enabled
    with torch.no_grad():
        dec(skips, plain=True)
        dec5, skips5 = _decoder_case(kernel_size=5)
        (mask, *_), _ = dec5(skips5)
    assert record == []
    assert mask.shape == (2, 1, 64, 128)
