"""The port's matcher (rsis_tpu_torch/ops/lap.py, ops/matching.py) against
the JAX package's: the unrolled ``hungarian`` and ``hungarian_pallas``
with the Pallas LAP kernel in interpret mode. On CPU tensors the port's
``solve_lap_batch`` runs its plain version, the oracle the CUDA kernel
(csrc/lap.cu) is held against on the card.

Any cost-optimal assignment is acceptable to every caller, so ties are
compared by total cost (1e-5 relative); where the optimum is unique
(continuous random costs) the (B, N) perms must be identical, which also
holds the port to the zero-pad convention for unmatched GT rows. The cost
shapes are the train step's: (B, N GT slots, M <= N predictions), with
the invalid pairs set to exactly 10.0 as the loss sets them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from rsis_tpu.ops import matching as jmatch
from rsis_tpu.ops.pallas_matching import solve_lap_batch as jax_lap
from rsis_tpu_torch.ops import matching as tmatch
from rsis_tpu_torch.ops.lap import solve_lap_batch, solve_lap_batch_ref
from torch_threads import one_torch_thread  # noqa: F401

B = 4


def _costs(n, m, ties, seed):
    """(B, N, M) fp32 costs. ties: values on a grid of quarters, and the
    (GT, prediction) pairs outside each sample's valid prefix set to 10.0,
    as step.py's loss builds them."""
    rng = np.random.default_rng(seed)
    c = rng.random((B, n, m)).astype(np.float32)
    if ties:
        c = np.floor(c * 4) / 4
        valid_n = rng.integers(1, n + 1, size=(B, 1))
        sw = (np.arange(n)[None] < valid_n).astype(np.float32)
        valid = sw[:, :, None] * sw[:, None, :m]
        c = (c * valid + (1 - valid) * 10.0).astype(np.float32)
    return c


def _perm_cost(costs, perm):
    """Total cost of each sample's matched (GT, prediction) pairs, after
    checking perm permutes range(N)."""
    perm = np.asarray(perm)
    n, m = costs.shape[1:]
    for p in perm:
        assert sorted(p.tolist()) == list(range(n))
    return np.array([costs[b, perm[b, :m], np.arange(m)].sum()
                     for b in range(len(perm))])


CASES = [(5, 3, False), (5, 5, False), (6, 4, True), (20, 5, True),
         (20, 20, True)]


@pytest.mark.parametrize("n,m,ties", CASES)
def test_hungarian_matches_jax(n, m, ties):
    costs = _costs(n, m, ties, seed=n * 31 + m)
    got = tmatch.hungarian(torch.from_numpy(costs))
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, n)
    want = np.asarray(jmatch.hungarian_pallas(jnp.asarray(costs),
                                              interpret=True))
    got_cost = _perm_cost(costs, got.numpy())
    np.testing.assert_allclose(got_cost, _perm_cost(costs, want),
                               rtol=1e-5)
    if n <= 6:     # the unrolled JAX solver compiles quickly when N is small
        want_unrolled = np.asarray(jmatch.hungarian(jnp.asarray(costs)))
        np.testing.assert_allclose(got_cost,
                                   _perm_cost(costs, want_unrolled),
                                   rtol=1e-5)
    if not ties:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nr,nc,ties", [(5, 20, True), (7, 13, False),
                                        (1, 1, False), (20, 20, True)])
def test_lap_matches_pallas_and_scipy(nr, nc, ties):
    costs = _costs(nc, nr, ties, seed=nr + nc).transpose(0, 2, 1).copy()
    got = solve_lap_batch(torch.from_numpy(costs)).numpy()
    want = np.asarray(jax_lap(jnp.asarray(costs), interpret=True))
    assert got.dtype == np.int32 and got.shape == (B, nc)
    for b in range(B):
        for r4c in (got[b], want[b]):
            assert sorted(r4c[r4c >= 0].tolist()) == list(range(nr))
        total = [costs[b][r4c[r4c >= 0], np.flatnonzero(r4c >= 0)].sum()
                 for r4c in (got[b], want[b])]
        rows, cols = linear_sum_assignment(costs[b])
        opt = costs[b][rows, cols].sum()
        np.testing.assert_allclose(total, [opt, opt], rtol=1e-5)


def test_lap_tie_break_prefers_unassigned_column():
    """All-equal costs: each row takes the lowest free column, as the
    kernel's tie-break (pallas_matching.py:112-118) does."""
    got = solve_lap_batch_ref(torch.zeros(1, 3, 5))
    assert got.tolist() == [[0, 1, 2, -1, -1]]


def test_perm_from_row4col_matches_jax():
    rng = np.random.default_rng(0)
    n, m = 7, 4
    r4c = np.full((B, n), -1, np.int32)
    for b in range(B):
        r4c[b, rng.permutation(n)[:m]] = np.arange(m)
    got = tmatch.perm_from_row4col(torch.from_numpy(r4c), m)
    for b in range(B):
        want = jmatch._perm_from_row4col(jnp.asarray(r4c[b]), n, m)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_match_gt_to_predictions_matches_jax():
    rng = np.random.default_rng(4)
    n, m, hw = 5, 3, 6
    y_mask = (rng.random((B, n, hw)) > 0.5).astype(np.float32)
    y_class = rng.integers(0, 4, size=(B, n)).astype(np.int32)
    costs = _costs(n, m, False, seed=4)
    got = tmatch.match_gt_to_predictions(
        torch.from_numpy(y_mask), torch.from_numpy(y_class).long(),
        torch.from_numpy(costs))
    want = jmatch.match_gt_to_predictions(
        jnp.asarray(y_mask), jnp.asarray(y_class), jnp.asarray(costs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
