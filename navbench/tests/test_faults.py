"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, check) at a tiny size on the CPU,
with each fault that a cell can have planted in the port. The cells run
on one card, so no exchange between cards can be left out; the online cell
steps one mission, so it has no batch to halve."""

import pytest
import torch

from navbench import manifest, run
from navbench.tests.small import sizes

from smarc_navigation_tpu_torch.models import ekf_slam
from smarc_navigation_tpu_torch.ops import assignment, slam_da_kernels

BENCH = manifest.benchmark()
FLEET = [w["name"] for w in BENCH["workloads"] if manifest.workload(w["name"])["driver"]
         == "fleet_replay"]
ONLINE = [w["name"] for w in BENCH["workloads"] if manifest.workload(w["name"])["driver"]
          == "online_step"]


def _fleet_state_unchanged(mp):
    real = ekf_slam._full_tick

    def tick(state, band, *a, **k):
        _, _, out = real(state, band, *a, **k)
        return state, band, out
    mp.setattr(ekf_slam, "_full_tick", tick)


def _fleet_half_batch(mp):
    real = ekf_slam._full_tick

    def tick(state, band, *a, **k):
        new, nb, out = real(state, band, *a, **k)
        h = state.mu.shape[0] // 2
        new = ekf_slam.SlamState(*(torch.cat([n[:h], o[h:]]) for n, o in zip(new, state)))
        out["mu"] = new.mu[:, 0:6]
        out["n_active"] = new.n_active
        return new, torch.cat([nb[:h], band[h:]]), out
    mp.setattr(ekf_slam, "_full_tick", tick)


def _fleet_answer_altered(mp):
    real = slam_da_kernels.da_lanes

    def da(*a, **k):      # every call drops its first new landmark
        res = list(real(*a, **k))
        do, add = res[5], res[6]
        if bool(add.any()):
            b, i = (int(x) for x in torch.nonzero(add)[0])
            do, add = do.clone(), add.clone()
            do[b, i] = add[b, i] = False
            res[5], res[6] = do, add
        return tuple(res)
    mp.setattr(slam_da_kernels, "da_lanes", da)


def _online_state_unchanged(mp):
    real = ekf_slam.step

    def step(cfg, params, state, tick, *a, **k):
        _, out = real(cfg, params, state, tick, *a, **k)
        return state, out
    mp.setattr(ekf_slam, "step", step)


def _online_answer_altered(mp):
    real = assignment.hungarian

    def hungarian(cost):  # every call's closest match made a new landmark
        c2r = real(cost)
        L = cost.shape[0] - cost.shape[1]
        known = torch.nonzero(c2r < L).flatten()
        if len(known):
            d = cost[c2r[known].long(), known]
            i = int(known[torch.argmin(d)])
            c2r = c2r.clone()
            c2r[i] = L + i
        return c2r
    mp.setattr(assignment, "hungarian", hungarian)


CASES = ([(c, f) for c in FLEET for f in (_fleet_state_unchanged, _fleet_half_batch,
                                          _fleet_answer_altered)]
         + [(c, f) for c in ONLINE for f in (_online_state_unchanged, _online_answer_altered)])


@pytest.mark.parametrize("cell,fault", CASES, ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    seconds = 10.0 if cell in ONLINE else 0.3   # the online window covers the tiny mission
    out, _ = run.run_cell(cell, 2**31 + 23, seconds, False, "cpu", sizes=sizes(cell))
    assert out["attempted"] >= (sizes(cell)["T"] if cell in ONLINE else 2)
    assert out["correct"] is False, out["checks"]
