"""The design of K6, the LAP matcher's kernel (``csrc/lap.cu``), mirrored in
numpy lane by lane, and its wrapper's strided path.

No card here: ``lane_solve`` runs the kernel's algorithm as the warp runs
it (column j on lane j % 32 in slot j // 32, row i likewise; the cost
matrix staged once; each step the order-preserving key of spc, the lane's
best slot, the warp minimum of the key and then of assigned << 14 |
column << 7 | row among the lanes that hold it; the dual update reading
spc at each row's column by one shuffle a slot; the augmentation two
shuffles a hop) and must give the identical row4col to the plain version
``_solve_one`` at every shape from 1 x 1 to 128 x 128 on random,
tie-heavy, all-equal and negative costs (with -0.0), and the same total
cost (1e-5 relative) as JAX's ``solve_lap_batch`` in interpret mode and
scipy. A hypothesis test holds the key to the float order. ``hungarian``
passes the transposed view of its costs, and ``lap_launch_args`` checks
what the CUDA launch takes on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.optimize import linear_sum_assignment

from rsis_tpu.ops.pallas_matching import solve_lap_batch as jax_lap
from rsis_tpu_torch.ops import lap
from rsis_tpu_torch.ops.matching import hungarian, perm_from_row4col
from torch_threads import one_torch_thread  # noqa: F401

INF = np.float32(1e9)
NONE = np.uint32(0xFFFFFFFF)
SHAPES = [(1, 1), (5, 20), (7, 13), (20, 20), (31, 32), (32, 33), (33, 64),
          (20, 128), (128, 128)]


def order_key(x):
    """The kernel's order_key: float32 -> uint32 whose order is the float
    order, -0.0 keyed as +0.0 (x + 0.0 first)."""
    b = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(b & np.uint32(0x80000000), ~b,
                    b | np.uint32(0x80000000)).astype(np.uint32)


def key_value(k):
    k = np.uint32(k)
    bits = k & np.uint32(0x7FFFFFFF) if k & np.uint32(0x80000000) else ~k
    return np.uint32(bits).view(np.float32)


def lane_solve(cost):
    """row4col of one (nr, nc) float32 problem as the kernel's warp solves
    it: state arrays (S, 32), [slot, lane] = column (or row) 32 slot +
    lane."""
    nr, nc = cost.shape
    s_n = -(-nc // 32)
    ids = np.arange(32)[None, :] + 32 * np.arange(s_n)[:, None]
    live = ids < nc
    staged = np.zeros((nr, 32 * s_n), np.float32)   # the shared memory
    staged[:, :nc] = cost
    u = np.zeros((s_n, 32), np.float32)
    v = np.zeros((s_n, 32), np.float32)
    c4r = np.full((s_n, 32), -1, np.int64)
    r4c = np.full((s_n, 32), -1, np.int64)
    for cur_row in range(nr):
        spc = np.full((s_n, 32), INF, np.float32)
        pred = np.zeros((s_n, 32), np.int64)
        scanned = np.zeros((s_n, 32), bool)
        rows_scanned = np.zeros((s_n, 32), bool)
        icur, min_val = cur_row, np.float32(0.0)
        while True:
            ui = u[icur // 32, icur % 32]              # one shuffle
            rows_scanned[icur // 32, icur % 32] = True
            crow = staged[icur].reshape(s_n, 32)
            best_key = np.full(32, NONE, np.uint32)
            best_tag = np.full(32, NONE, np.uint32)
            for s in range(s_n):                       # the lane's slots
                act = live[s] & ~scanned[s]
                red = ((min_val + crow[s]) - ui) - v[s]
                upd = act & (red < spc[s])
                spc[s] = np.where(upd, red, spc[s])
                pred[s] = np.where(upd, icur, pred[s])
                key = order_key(spc[s])
                tag = np.where(r4c[s] >= 0,
                               (1 << 14) | (ids[s] << 7) | r4c[s],
                               ids[s] << 7).astype(np.uint32)
                better = act & ((key < best_key)
                                | ((key == best_key) & (tag < best_tag)))
                best_key = np.where(better, key, best_key)
                best_tag = np.where(better, tag, best_tag)
            kmin = best_key.min()                      # __reduce_min_sync
            tmin = np.where(best_key == kmin, best_tag, NONE).min()
            j = int((tmin >> 7) & 127)
            scanned[j // 32, j % 32] = True
            min_val = key_value(kmin)
            if not tmin >> 14:
                sink = j
                break
            icur = int(tmin & 127)
        # dual update: rows read spc at their column, one shuffle a slot
        for s in range(s_n):
            if 32 * s >= nr:
                break
            col = c4r[s]
            at = np.zeros(32, np.float32)
            for t in range(s_n):
                got = spc[t][col & 31]                 # __shfl_sync
                at = np.where((col >> 5) == t, got, at)
            me = ids[s] == cur_row
            others = rows_scanned[s] & ~me
            u[s] = np.where(me, u[s] + min_val,
                            np.where(others, u[s] + (min_val - at), u[s]))
        reached = scanned & (spc < INF * np.float32(0.5))
        v = np.where(reached, v - (min_val - spc), v).astype(np.float32)
        # augmentation: two shuffles a hop, the owning lanes write
        j = sink
        while True:
            ipred = int(pred[j // 32, j % 32])
            jnext = int(c4r[ipred // 32, ipred % 32])
            r4c[j // 32, j % 32] = ipred
            c4r[ipred // 32, ipred % 32] = j
            if ipred == cur_row:
                break
            j = jnext
    return r4c.reshape(-1)[:nc]


def _costs(nr, nc, kind, seed):
    rng = np.random.default_rng(seed)
    c = rng.random((nr, nc)).astype(np.float32)
    if kind == "ties":            # quarters, invalid pairs 10.0 as the loss
        c = np.floor(c * 4) / 4
        valid = rng.integers(1, nc + 1)
        c[:, valid:] = 10.0
        c[min(valid, nr - 1):, :] = 10.0
    elif kind == "negative":      # negative values and -0.0
        c = c - np.float32(0.5)
        c[:, ::3] = np.float32(-0.0)
    elif kind == "equal-rows":    # all-equal rows, ties everywhere
        c = np.repeat(c[:, :1], nc, axis=1)
    return c.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "negative",
                                  "equal-rows"])
@pytest.mark.parametrize("nr,nc", SHAPES)
def test_lane_mirror_equals_plain_row4col(nr, nc, kind):
    cost = _costs(nr, nc, kind, seed=nr * 1000 + nc)
    want = lap._solve_one(cost)
    np.testing.assert_array_equal(lane_solve(cost), want)


@pytest.mark.parametrize("nr,nc", [(5, 20), (7, 13), (31, 32)])
def test_lane_mirror_cost_matches_jax_and_scipy(nr, nc):
    costs = np.stack([_costs(nr, nc, kind, seed=nc + i)
                      for i, kind in enumerate(["random", "ties",
                                                "negative"])])
    want = np.asarray(jax_lap(jnp.asarray(costs), interpret=True))
    for b, cost in enumerate(costs):
        rows, cols = linear_sum_assignment(cost)
        opt = cost[rows, cols].sum()
        for r4c in (lane_solve(cost), want[b]):
            assert sorted(r4c[r4c >= 0].tolist()) == list(range(nr))
            total = cost[r4c[r4c >= 0], np.flatnonzero(r4c >= 0)].sum()
            np.testing.assert_allclose(total, opt, rtol=1e-5)


@settings(max_examples=300, deadline=None, database=None)
@given(st.floats(width=32, allow_nan=False, allow_infinity=False),
       st.floats(width=32, allow_nan=False, allow_infinity=False))
def test_key_order_is_float_order(a, b):
    ka, kb = order_key(np.float32(a)), order_key(np.float32(b))
    assert (ka < kb) == (np.float32(a) < np.float32(b))
    assert (ka == kb) == (np.float32(a) == np.float32(b))
    assert key_value(ka) == np.float32(a)


def test_key_maps_negative_zero_to_positive_zero():
    assert order_key(np.float32(-0.0)) == order_key(np.float32(0.0))
    assert order_key(np.float32(-1e-45)) < order_key(np.float32(0.0))
    assert order_key(np.float32(1e9)) < NONE   # spc = INF stays choosable


def test_stats_count_steps_and_longest_problem():
    costs = torch.from_numpy(np.stack([_costs(6, 9, "ties", s)
                                       for s in range(4)]))
    stats = {}
    lap.solve_lap_batch_ref(costs, stats)
    each = []
    for i in range(4):
        one = {}
        lap.solve_lap_batch_ref(costs[i:i + 1], one)
        each.append(one["scans"])
    assert stats["scans"] == sum(each) and stats["max_scans"] == max(each)
    assert max(each) >= 6           # one step a row at least


def test_hungarian_reads_the_transposed_view(monkeypatch):
    """hungarian hands the (B, M, N) transposed view to the solver (no
    copy) and gets the perm of the contiguous costs; a non-contiguous
    (B, N, M) input as well."""
    import rsis_tpu_torch.ops.matching as matching
    rng = np.random.default_rng(3)
    c = torch.from_numpy(np.floor(rng.random((4, 12, 7)) * 4).astype(
        np.float32) / 4)
    want = perm_from_row4col(
        lap.solve_lap_batch_ref(c.transpose(1, 2).contiguous()), 7)
    assert torch.equal(hungarian(c), want)
    view = c.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    assert torch.equal(hungarian(view), want)
    seen = []
    monkeypatch.setattr(matching, "solve_lap_batch",
                        lambda x: seen.append(x) or lap.solve_lap_batch(x))
    assert torch.equal(hungarian(c), want)
    assert seen[0].stride() == (84, 1, 7)   # the view, not a copy


def test_launch_args_strides_and_checks():
    c = torch.zeros(3, 5, 20)
    assert lap.lap_launch_args(c) == (3, 5, 20, 100, 20, 1)
    t = torch.zeros(3, 20, 5).transpose(1, 2)
    assert lap.lap_launch_args(t) == (3, 5, 20, 100, 1, 5)
    one = torch.zeros(2, 8, 1).transpose(1, 2)     # nr = 1: row stride 1
    assert lap.lap_launch_args(one)[4] == 1
    with pytest.raises(TypeError, match="float32"):
        lap.lap_launch_args(c.double())
    with pytest.raises(ValueError, match="unit stride"):
        lap.lap_launch_args(torch.zeros(3, 10, 40)[:, ::2, ::2])
    with pytest.raises(ValueError, match="nr <= nc"):
        lap.lap_launch_args(torch.zeros(2, 6, 5))
    with pytest.raises(ValueError, match="nr <= nc"):
        lap.lap_launch_args(torch.zeros(2, 5, 129))
    with pytest.raises(ValueError, match="B, nr, nc"):
        lap.lap_launch_args(torch.zeros(5, 20))
    with pytest.raises(ValueError, match="nr <= nc"):
        lap.solve_lap_batch(torch.zeros(2, 6, 5))
