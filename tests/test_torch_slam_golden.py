"""Golden tracks: the port's single-mission EKF-SLAM (``run`` with full and
with marginal covariance writeback, plain versions on the CPU) against the
independent float64 numpy oracle of the reference C++ core
(``tests/oracles/ekf_slam_oracle.py``), on the missions of the JAX
package's own golden test (``tests/test_slam_golden.py``).

The bar is the JAX package's: identical association decisions over the
whole mission, equal landmark counts, pose error below 5 cm, and the
landmark map equal slot for slot to 5 cm.
"""

import dataclasses

import numpy as np
import pytest

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_slam as S
from tests.oracles import ekf_slam_oracle as oracle

FULL_CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=32, max_obs=8, mhl_dist_mbes=1.0,
    q_mbes_diag=(0.1, 0.1, 0.1), r_diag=(1e-3,) * 6)
MARGINAL_CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=32, max_obs=8)
CASES = {
    "full": (FULL_CFG, dict(duration_s=30.0, num_landmarks=15, mbes_std=0.02,
                            landmark_area_m=40.0, mbes_range_m=30.0)),
    "marginal": (MARGINAL_CFG, dict(duration_s=20.0, num_landmarks=10, mbes_std=0.05,
                                    landmark_area_m=40.0, mbes_range_m=30.0)),
}


def _timeline_np(tl):
    od, ev = tl.channels["odom"], tl.events["mbes"]
    return {
        "ticks": np.asarray(tl.ticks, np.float64),
        "odom_value": np.asarray(od.value, np.float64),
        "odom_valid": np.asarray(od.valid),
        "det_value": np.asarray(ev.value, np.float64),
        "det_mask": np.asarray(ev.mask),
    }


@pytest.mark.parametrize("update_mode", ["full", "marginal"])
def test_run_matches_f64_oracle(update_mode):
    cfg, spec = CASES[update_mode]
    m = sim.simulate(sim.MissionSpec(**spec))
    ticks = np.arange(0, spec["duration_s"] + 1e-9, 1.0 / cfg.system_freq)
    tl_np = S.slam_timeline(m, m.gt_at(ticks).astype(np.float32), ticks, cfg)
    final, out = S.run(tl_np.to("cpu"), S.make_params(cfg, device="cpu"), cfg,
                       update_mode=update_mode)
    mus_o, matched_o, o = oracle.run_oracle(cfg, _timeline_np(tl_np), update_mode)

    assert int(final.n_active) == o.n_active
    np.testing.assert_array_equal(out["matched_mbes"].numpy(), matched_o)
    err = np.linalg.norm(out["mu"].numpy()[:, :3] - mus_o[:, :3], axis=-1)
    assert err.max() < 5e-2, err.max()
    lm, active = S.landmarks_map(final, cfg)
    assert int(active.sum()) == o.n_active
    np.testing.assert_allclose(lm.numpy()[: o.n_active],
                               o.mu[6:6 + 3 * o.n_active].reshape(-1, 3), atol=5e-2)
    assert o.n_active >= 5 and (matched_o >= 0).sum() > 50
