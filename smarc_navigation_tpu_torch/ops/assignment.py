"""Exact linear assignment for SLAM data association (port of the
reference's ``ops/assignment.py``).

``hungarian`` is the Jonker-Volgenant shortest-augmenting-path Hungarian
with the reference's exact arithmetic and tie rule (on equal slack the
lowest row index wins, as ``jnp.argmin`` picks it), so both packages make
identical association decisions on identical cost tables. It is a host loop
with data-dependent control flow: the table is solved on the CPU and the
result returned on the table's device. The fleet path never calls it — the
DA kernel (``ops.slam_da_kernels``) runs its own JV on the card.

``hungarian_host`` is the reference's host solver (``solver="host"`` of
``ekf_slam``): the native C++ JV (``native.jv_assign``, the same algorithm
and tie rule) on the table in float64 when the library builds, scipy's
``linear_sum_assignment`` otherwise. scipy finds the same optimum; where
several assignments share it, it may pick another one.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = 1e30


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment of every column to a distinct row.

    cost: (R, C) with C <= R. Returns col_to_row (C,) int32 on cost's device.
    Dual potentials u (columns) and v (rows), Dijkstra-style augmenting
    paths from a virtual start row at index R."""
    R, C = cost.shape
    if C > R:
        raise ValueError("hungarian requires C <= R (pad candidate rows)")
    device = cost.device
    cost = cost.detach().to("cpu")
    dtype = cost.dtype
    inf = torch.tensor(_INF, dtype=dtype)
    zero = torch.zeros((), dtype=dtype)

    u = torch.zeros(C, dtype=dtype)
    v = torch.zeros(R + 1, dtype=dtype)
    p = torch.full((R + 1,), -1, dtype=torch.int64)  # column at row j; -1 free
    for c in range(C):
        p[R] = c
        minv = torch.full((R + 1,), _INF, dtype=dtype)
        minv[R] = -_INF                                  # root always "used"
        way = torch.full((R + 1,), R, dtype=torch.int64)
        used = torch.zeros(R + 1, dtype=torch.bool)
        used[R] = True
        j0 = R
        while True:
            i0 = int(p[j0])                  # column occupying current row
            cur = cost[:, i0] - u[i0] - v[:R]
            better = (cur < minv[:R]) & ~used[:R]
            minv[:R] = torch.where(better, cur, minv[:R])
            way[:R] = torch.where(better, torch.tensor(j0), way[:R])

            masked = torch.where(used[:R], inf, minv[:R])
            j1 = int(torch.argmin(masked))   # first minimum: lowest row wins
            delta = masked[j1]

            # dual update: every used row's assigned column gains delta,
            # used rows' potentials drop, unused slacks shrink
            upd = used & (p >= 0)
            u = u + torch.zeros(C, dtype=dtype).index_add_(
                0, p.clamp(min=0), torch.where(upd, delta, zero))
            v = v - torch.where(used, delta, zero)
            minv = torch.where(used, minv, minv - delta)

            used[j1] = True
            j0 = j1
            if int(p[j1]) < 0:               # reached a free row
                break
        # augment: walk the predecessor chain back to the virtual root
        j = j0
        while j != R:
            j1 = int(way[j])
            p[j] = p[j1]
            j = j1
        p[R] = -1

    col_to_row = torch.full((C,), -1, dtype=torch.int32)
    rows = torch.nonzero(p[:R] >= 0).flatten()
    col_to_row[p[rows]] = rows.to(torch.int32)
    return col_to_row.to(device)


def _scipy_solve(cost: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[1], -1, np.int32)
    out[cols] = rows.astype(np.int32)
    return out


def _host_solve(cost: np.ndarray) -> np.ndarray:
    """Native C++ JV when built (the Munkres-solver slot of the reference),
    scipy otherwise (``smarc_navigation_tpu/ops/assignment.py:130-139``).
    The JV assigns every column, so it takes C <= R; a wider table goes to
    scipy, which leaves the columns past the rows unassigned (the
    reference's native path raises there)."""
    from .. import native

    if cost.shape[1] <= cost.shape[0] and native.available():
        return native.jv_assign(cost)
    return _scipy_solve(cost)


def hungarian_host(cost: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment solved on the host in float64.

    cost: (R, C). Returns col_to_row (C,) int32 on cost's device, -1 for a
    column left unassigned (only where C > R)."""
    c = cost.detach().to("cpu", torch.float64).numpy()
    return torch.from_numpy(_host_solve(c)).to(cost.device)


def assignment_cost(cost: torch.Tensor, col_to_row: torch.Tensor) -> torch.Tensor:
    return torch.sum(cost[col_to_row.long(), torch.arange(cost.shape[1], device=cost.device)])
