"""K11 (``hungarian_lanes``): the fleet's exact assignment against the JAX
package's ``hungarian_lanes`` (TPU-interpret mode) and against scipy's
optimum, on random (B, R, C) costs with unusable (1e30) rows and ties.

The assignment is exact: the port's ``col_to_row`` equals JAX's entry for
entry (same duals, same lowest-row tie rule), and its cost equals scipy's
optimum. The ``cuda`` test holds the CUDA kernel against its plain version
on the card.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from smarc_navigation_tpu_torch.ops import assignment
from smarc_navigation_tpu_torch.ops import slam_da_kernels as tda

INF = assignment._INF


def _costs(seed, B=4, R=12, C=4):
    """Integer-valued costs (ties), some rows unusable, and the SLAM table's
    shape: each column has a finite candidate row of its own at the bottom."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 6, (B, R, C)).astype(np.float32)
    for b in range(B):
        cost[b, rng.choice(R - C, 3, replace=False)] = INF
        cost[b, R - C:] = INF
        cost[b, np.arange(R - C, R), np.arange(C)] = 7.0
    cost[0, :, :] = np.where(cost[0] < INF, 2.0, INF)      # all ties
    return cost


def _optimum(c):
    r, k = linear_sum_assignment(np.where(c >= INF, 1e9, c.astype(np.float64)))
    return c[r, k].astype(np.float64).sum()


# R across the CUDA JV's rows-per-lane boundaries (32 rows a lane each), on
# integer costs: the ties pin the rule the kernel keeps (on equal slack the
# lowest row wins)
TIE_CASES = [pytest.param(0, 4, 12, 4, id="0"), pytest.param(1, 4, 12, 4, id="1")] + [
    pytest.param(2 + i, B, R, 8, id=f"ties-B{B}-R{R}-C8")
    for i, (B, R) in enumerate([(4, 31), (4, 32), (4, 33), (2, 65)])]


@pytest.mark.parametrize("seed,B,R,C", TIE_CASES)
def test_hungarian_lanes_plain_matches_jax_and_scipy(seed, B, R, C):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.ops.slam_da_kernels import hungarian_lanes as j_hungarian_lanes

    cost = _costs(seed, B, R, C)
    got = tda.hungarian_lanes(torch.from_numpy(cost))
    assert got.dtype == torch.int32 and got.shape == (B, C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_hungarian_lanes(jnp.asarray(cost)))
    np.testing.assert_array_equal(got.numpy(), want)
    C = cost.shape[2]
    for b in range(cost.shape[0]):
        ctr = got[b].numpy()
        assert len(set(ctr.tolist())) == C
        total = cost[b][ctr, np.arange(C)].astype(np.float64).sum()
        assert total == _optimum(cost[b]), (b, ctr)


def test_hungarian_lanes_checks_its_input():
    with pytest.raises(ValueError, match="C <= R"):
        tda.hungarian_lanes(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError, match="dtype"):
        tda.hungarian_lanes(torch.zeros(2, 5, 4, dtype=torch.float64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# R on both sides of the CUDA JV's rows-per-lane boundaries (32 rows a
# lane), C up to 16 and past 32 (the column duals then live in shared
# memory), integer costs (ties), B=1
@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", [(16, 40, 8), (4, 32, 8), (4, 33, 8), (4, 64, 8), (4, 65, 16),
                                   (4, 256, 8), (4, 257, 16), (4, 264, 8), (4, 272, 16),
                                   (1, 72, 8), (1, 264, 16), (2, 80, 40)])
def test_hungarian_lanes_kernel_matches_plain(cuda, B, R, C):
    # four missions a seed, the first of each all ties; B=1 takes a mixed one
    tables = np.concatenate([_costs(s, R=R, C=C) for s in range((B + 3) // 4)])
    cost = torch.from_numpy(tables[1:2] if B == 1 else tables[:B])
    n0 = tda.hungarian_lanes.launches
    got = tda.hungarian_lanes(cost.to(cuda))
    torch.cuda.synchronize()
    assert tda.hungarian_lanes.launches == n0 + 1
    assert torch.equal(got.cpu(), tda.hungarian_lanes_reference(cost))


# past the register JV (R > 1024: 1025, 2048) and past shared memory (a
# 400 x 160 table is 256 KB): the scratch form against the plain version
@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", [(3, 1025, 8), (2, 2048, 16), (2, 400, 160)])
def test_hungarian_lanes_kernel_past_the_register_jv(cuda, B, R, C):
    tables = np.concatenate([_costs(s, R=R, C=C) for s in range((B + 3) // 4)])
    cost = torch.from_numpy(tables[:B])
    got = tda.hungarian_lanes(cost.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tda.hungarian_lanes_reference(cost))


# where both forms run, the scratch form is the register form bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", [(16, 40, 8), (4, 65, 16), (4, 264, 8), (2, 80, 40),
                                   (2, 1024, 8)])
def test_hungarian_lanes_scratch_form_is_the_register_form(cuda, monkeypatch, B, R, C):
    tables = np.concatenate([_costs(s, R=R, C=C) for s in range((B + 3) // 4)])
    cost = torch.from_numpy(tables[:B]).to(cuda)
    reg = tda.hungarian_lanes(cost)
    monkeypatch.setattr(tda, "FORCE_SCRATCH", True)
    scr = tda.hungarian_lanes(cost)
    torch.cuda.synchronize()
    assert torch.equal(reg, scr)
