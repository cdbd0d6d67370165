"""The host-side plan of K7, the augmentation warp
(``ops/warp.py::warp_plan``), and the kernel's segments (``csrc/warp.cu``)
mirrored in numpy.

No card here: ``mirror_warp`` runs the kernel as its warps run it (a warp a
segment of 32 v pixels of one row; lane l the source indices of pixels l +
32 k, computed with the fp32 expression tree of each pixel; the gathers as
the plan's load says, the element-interleaved one through the kernel's
shuffle of the pixel's source from the lane that computed it, the vector
one a pixel a load; the segment
staged in output order and stored in chunks, lane q the chunks q, q + 32,
...) on the elements' bits, checks that every store and every vector load
is aligned to its width and every output byte is written once, and must
be bit-equal to ``affine_warp_ref`` at the train shapes' plan, at every
``chip_smoke.K7_EDGE_GEOMS`` entry in fp32 and bf16 with each gather and
a misaligned image, and to JAX's ``affine_warp_planes`` in interpret mode
at one small shape. The plan itself covers every output pixel once
and stores the train shapes in 16-byte chunks."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsis_tpu.data.device_aug import sample_affine_matrices as jax_mats
from rsis_tpu.ops.pallas_warp import affine_warp_planes
from rsis_tpu_torch.ops import warp
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (B, H, W, C) of the train step's image (256x512, B = 32 and 8), bf16
TRAIN_SHAPES = [(32, 256, 512, 3), (8, 256, 512, 3)]
EDGES = chip_smoke.K7_EDGE_GEOMS
DTYPES = {torch.float32: np.uint32, torch.bfloat16: np.uint16}


def _row_stores(bytes_, width):
    """(offset, width) of the chunk stores of one segment's bytes, as the
    kernel's store_chunks makes them: width-byte chunks, then narrower
    ones for what is left."""
    stores, done = [], 0
    for wd in (16, 8, 4, 2, 1):
        if wd > width:
            continue
        n = (bytes_ - done) // wd
        stores += [(done + q * wd, wd) for q in range(n)]
        done += n * wd
    return stores


def _segments(plan, w):
    """(first pixel, pixels) of each segment of a row."""
    seg = 32 * plan.v
    return [(c0, min(seg, w - c0)) for c0 in range(0, w, seg)]


def _check_plan(plan, w, c, elem):
    """The plan's segments cover each pixel of a row once, each image and
    id store lies aligned to its width at every row (the row's bytes are a
    multiple of the widest store), and each byte is stored once."""
    pixels = np.zeros(w, np.int64)
    for c0, n in _segments(plan, w):
        pixels[c0:c0 + n] += 1
        for bytes_, width, size in ((n * c * elem, plan.img_store, c * elem),
                                    (n, plan.ids_store, 1)):
            hits = np.zeros(bytes_, np.int64)
            for off, wd in _row_stores(bytes_, width):
                assert (c0 * size + off) % wd == 0
                hits[off:off + wd] += 1
            assert (hits == 1).all()
    assert (pixels == 1).all()
    assert (w * c * elem) % plan.img_store == 0 and w % plan.ids_store == 0


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_train_shapes_take_16_byte_stores(shape):
    b, h, w, c = shape
    plan = warp.warp_plan(w, c, 2)
    assert plan.v == warp.WARP_LANE_PIXELS and plan.load == "elements"
    assert plan.img_store == 16 and plan.ids_store == 16
    _check_plan(plan, w, c, 2)
    # a whole row a warp, each of its stores 16 bytes
    assert _segments(plan, w) == [(0, 512)]
    assert {wd for _, wd in _row_stores(w * c * 2, 16)} == {16}
    assert plan.blocks(b, h, w) == b * h // warp.WARP_SEGMENTS


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", EDGES)
def test_plan_covers_every_pixel_once(geom, dtype):
    _, _, w, c = geom
    elem = torch.empty((), dtype=dtype).element_size()
    for align in (16, elem):
        plan = warp.warp_plan(w, c, elem, align)
        assert plan.v == warp.WARP_LANE_PIXELS
        _check_plan(plan, w, c, elem)
        assert plan.load == ("vector" if c * elem in (4, 8, 16)
                             and align % (c * elem) == 0 else "elements")


def test_plan_gathers_by_pixel_bytes_and_alignment():
    """One pixel a thread past four channels; a vector gather only where a
    pixel is 4, 8 or 16 bytes and the image's address is aligned to it."""
    assert warp.warp_plan(64, 5, 4) == warp.WarpPlan(1, 4, 1, "elements")
    assert warp.warp_plan(64, 3, 2).load == "elements"        # 6 bytes
    assert warp.warp_plan(64, 3, 4).load == "elements"        # 12 bytes
    for c, elem in ((2, 2), (1, 4), (4, 2), (2, 4), (4, 4)):
        assert warp.warp_plan(64, c, elem).load == "vector"
        assert warp.warp_plan(64, c, elem, c * elem).load == "vector"
        assert warp.warp_plan(64, c, elem, c * elem // 2).load == "elements"


def _source_pixels(coef, r, cols, h, w):
    """The kernel's source_pixel for output row r and columns cols:
    float32, each product and sum rounded on its own, half to even."""
    p, q, m, u, v, o = (np.float32(x) for x in coef[:6])
    rf = np.float32(r)
    cf = cols.astype(np.float32)
    src_r = p * rf + (q * cf + m)
    src_c = v * rf + (u * cf + o)
    rr = np.clip(np.rint(src_r), 0, h - 1).astype(np.int64)
    cc = np.clip(np.rint(src_c), 0, w - 1).astype(np.int64)
    if coef[8] > 0:
        cc = (w - 1) - cc
    return rr * w + cc


def mirror_warp(img_bits, ids, coef, plan, elem, img_offset=0):
    """The kernel's warps on the raw bits: img_bits (B, H, W, C) uint16 or
    uint32, ids (B, H, W) uint8, coef (B, 10) float32; the image's data
    address img_offset bytes past a 16-byte boundary (the outputs are
    aligned). Returns (img_out bits, ids_out)."""
    b, h, w, c = img_bits.shape
    flat = img_bits.reshape(b, h * w * c)
    ids_flat = ids.reshape(b, h * w)
    out = np.zeros((b, h * w * c * elem), np.uint8)
    out_ids = np.zeros((b, h * w), np.uint8)
    hits = np.zeros_like(out, np.int64)
    hits_ids = np.zeros_like(out_ids, np.int64)
    lanes = np.arange(32)
    v = plan.v
    for bi in range(b):
        for r in range(h):
            for c0, n in _segments(plan, w):
                # 1. lane l: the sources of pixels l + 32 k (clamped to the
                # row's last pixel past its end)
                src = np.stack([_source_pixels(
                    coef[bi], r, np.minimum(c0 + lanes + 32 * k, w - 1), h,
                    w) for k in range(v)])                  # (v, 32)
                # 2. gathers, 3. staged in output order
                stage = np.zeros(32 * v * c, img_bits.dtype)
                if plan.load == "elements":
                    for mm in range(v * c):
                        q = lanes + 32 * mm
                        p = q // c
                        p0 = 32 * mm // c
                        k0 = p0 // 32
                        mine = np.where(lanes >= p0 % 32, src[k0],
                                        src[min(k0 + 1, v - 1)])
                        sp = mine[p & 31]                   # __shfl_sync
                        assert (sp == src[p // 32, p % 32]).all()
                        got = flat[bi, sp * c + (q - p * c)]
                        keep = q < n * c
                        stage[q[keep]] = got[keep]
                else:
                    for k in range(v):
                        assert ((img_offset + src[k] * c * elem)
                                % (c * elem) == 0).all()
                        px = lanes + 32 * k
                        keep = px < n
                        for i in range(c):
                            stage[px[keep] * c + i] = flat[bi, src[k] * c
                                                           + i][keep]
                stage_ids = np.zeros(32 * v, np.uint8)
                for k in range(v):
                    px = lanes + 32 * k
                    keep = px < n
                    stage_ids[px[keep]] = ids_flat[bi, src[k]][keep]
                # the segment's chunk stores
                dst = r * w + c0
                raw = stage.view(np.uint8)
                for off, wd in _row_stores(n * c * elem, plan.img_store):
                    start = dst * c * elem + off
                    assert start % wd == 0
                    out[bi, start:start + wd] = raw[off:off + wd]
                    hits[bi, start:start + wd] += 1
                for off, wd in _row_stores(n, plan.ids_store):
                    assert (dst + off) % wd == 0
                    out_ids[bi, dst + off:dst + off + wd] = \
                        stage_ids[off:off + wd]
                    hits_ids[bi, dst + off:dst + off + wd] += 1
    assert (hits == 1).all() and (hits_ids == 1).all()
    return (out.view(img_bits.dtype).reshape(img_bits.shape),
            out_ids.reshape(ids.shape))


def _case(shape, dtype, seed, strong=True):
    """Image, ids and coefficients from numpy (seeded), matrices from the
    port's sampler on a CPU generator."""
    from rsis_tpu_torch.data.device_aug import sample_affine_matrices
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)
    ids = torch.from_numpy(rng.integers(0, 21, (b, h, w)).astype(np.uint8))
    gen = torch.Generator().manual_seed(seed)
    ranges = ((15.0, 0.4, 5.0, (0.8, 1.2)) if strong
              else chip_smoke.WARP_RANGES)
    ms = sample_affine_matrices(gen, b, h, w, *ranges)
    flip = torch.from_numpy(rng.random(b) < 0.5)
    return img, ids, warp.warp_coefficients(img, ms, flip)


def _bits(t):
    """A float tensor's elements as unsigned integers of its width."""
    dt = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.view(dt).numpy().view(DTYPES[t.dtype])


def _assert_mirror_equals_ref(img, ids, coef, plan, img_offset=0):
    want_img, want_ids = warp.affine_warp_ref(img, ids, coef)
    got_img, got_ids = mirror_warp(_bits(img), ids.numpy(),
                                   coef.numpy(), plan, img.element_size(),
                                   img_offset)
    np.testing.assert_array_equal(got_img, _bits(want_img))
    np.testing.assert_array_equal(got_ids, want_ids.numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", EDGES)
def test_mirror_equals_plain_at_edges(geom, dtype):
    """The plan's choice (the vector gather where it takes one), the
    element gather where it does not, and the misaligned image."""
    img, ids, coef = _case(geom, dtype, seed=sum(geom))
    _, _, w, c = geom
    elem = img.element_size()
    plan = warp.warp_plan(w, c, elem)
    _assert_mirror_equals_ref(img, ids, coef, plan)
    if plan.load == "vector":
        _assert_mirror_equals_ref(
            img, ids, coef, dataclasses.replace(plan, load="elements"))
    plan = warp.warp_plan(w, c, elem, elem)       # one element past 16
    assert plan.load == ("vector" if c * elem in (4, 8, 16)
                         and elem % (c * elem) == 0 else "elements")
    _assert_mirror_equals_ref(img, ids, coef, plan, img_offset=elem)


@pytest.mark.parametrize("dtype, c, load", [(torch.bfloat16, 3, "elements"),
                                            (torch.float32, 4, "vector")])
def test_mirror_equals_plain_at_train_width(dtype, c, load):
    """Two rows of the train step's 512-pixel width at the bench's ranges,
    bf16 RGB (element gathers) and fp32 with four channels (a pixel a
    load): the plan's v = 16, one segment a row."""
    img, ids, coef = _case((1, 2, 512, c), dtype, seed=5, strong=False)
    plan = warp.warp_plan(512, c, img.element_size())
    assert plan.load == load and _segments(plan, 512) == [(0, 512)]
    _assert_mirror_equals_ref(img, ids, coef, plan)


def test_mirror_equals_jax_pallas_interpret():
    """The Pallas kernel in interpret mode, planes (1, 1, 128, 128) with a
    flip, bit for bit against the mirror's plan (fp32, C = 1)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 128, 128, 1)).astype(np.float32)
    ms = np.array(jax_mats(jax.random.PRNGKey(11), 1, 128, 128, 10.0, 0.1,
                           10.0, (0.77, 1.0)))
    flip = np.asarray([True])
    want = np.asarray(affine_warp_planes(
        jnp.asarray(x.transpose(0, 3, 1, 2)), jnp.asarray(ms),
        flip=jnp.asarray(flip), interpret=True)).transpose(0, 2, 3, 1)
    img = torch.from_numpy(x)
    coef = warp.warp_coefficients(img, torch.from_numpy(ms),
                                  torch.from_numpy(flip))
    got, _ = mirror_warp(_bits(img), np.zeros((1, 128, 128), np.uint8),
                         coef.numpy(), warp.warp_plan(128, 1, 4), 4)
    np.testing.assert_array_equal(got, want.view(np.uint32))
