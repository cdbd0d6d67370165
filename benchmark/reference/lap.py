"""Exact rectangular linear assignment by shortest augmenting paths.

The formulation of Crouse (2016), which scipy's ``linear_sum_assignment``
follows: one Dijkstra over the columns a row, the dual update, the
augmentation, in float32. Ties of the reduced cost go to an unassigned
column, then to the lowest index, so an exact tie between two ground-truth
slots is broken as the train step's matcher breaks it.
"""

from __future__ import annotations

import numpy as np

_INF = np.float32(1e9)


def row4col(cost: np.ndarray) -> np.ndarray:
    """(nr, nc) float32 costs, nr <= nc -> (nc,) the row assigned to each
    column, -1 where none is."""
    cost = np.asarray(cost, np.float32)
    nr, nc = cost.shape
    u = np.zeros(nr, np.float32)
    v = np.zeros(nc, np.float32)
    r4c = np.full(nc, -1, np.int64)
    c4r = np.full(nr, -1, np.int64)
    cols = np.arange(nc)
    for cur_row in range(nr):
        spc = np.full(nc, _INF, np.float32)
        pred = np.zeros(nc, np.int64)
        seen_c = np.zeros(nc, bool)
        seen_r = np.zeros(nr, bool)
        sink, icur, min_val = -1, cur_row, np.float32(0.0)
        while sink == -1:
            seen_r[icur] = True
            red = min_val + cost[icur] - u[icur] - v
            upd = ~seen_c & (red < spc)
            spc[upd] = red[upd]
            pred[upd] = icur
            dist = np.where(seen_c, _INF, spc)
            lowest = dist.min()
            ties = (dist == lowest) & (r4c < 0)
            j = int(cols[ties][0] if ties.any() else cols[dist == lowest][0])
            seen_c[j] = True
            min_val = lowest
            if r4c[j] < 0:
                sink = j
            else:
                icur = int(r4c[j])
        rows = np.flatnonzero(seen_r)
        others = rows[rows != cur_row]
        u[others] = u[others] + (min_val - spc[c4r[others]])
        u[cur_row] = u[cur_row] + min_val
        reached = seen_c & (spc < _INF * np.float32(0.5))
        v[reached] = v[reached] - (min_val - spc[reached])
        j = sink
        while j >= 0:
            ipred = int(pred[j])
            jnext = int(c4r[ipred])
            r4c[j] = ipred
            c4r[ipred] = j
            j = -1 if ipred == cur_row else jnext
    return r4c


def match(costs: np.ndarray) -> np.ndarray:
    """(B, N, T) costs of N ground-truth slots against T <= N predictions
    -> (B, T) the slot matched to each prediction."""
    b, n, t = costs.shape
    out = np.zeros((b, t), np.int64)
    for i in range(b):
        r4c = row4col(costs[i].T)
        for slot in range(n):
            if r4c[slot] >= 0:
                out[i, r4c[slot]] = slot
    return out
