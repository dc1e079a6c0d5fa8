"""The port's event-compacted SLAM replay ``ekf_slam.run_fleet_compact``
and the combined mission ``parallel.fleet.run_combined``, against the JAX
package's and against the port's own ``run_fleet``.

The JAX side runs its Pallas kernels in TPU-interpret mode, on one timeline
shape only (the combined mission's B=1 SLAM timeline, which JAX's
``run_combined`` then takes from its jit cache): each shape costs about a
minute of interpret-mode compilation. Tolerances:
association decisions (matched_mbes) and n_active exact; pose tracks within
1e-3 (the compact path re-associates the odometry sums and composes the
motion covariance in another order; the reference's docstring,
``ekf_slam.py:1290-1293``); the combined scalar within 1e-4 relative.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.io import workloads
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.models import particle_filter as P
from smarc_navigation_tpu_torch.parallel import fleet

CFG = dataclasses.replace(workloads.combined_slam_cfg(), max_landmarks=12, max_obs=4)
DURATION = 4.0
POSE_ATOL = 1e-3
PF_CFG = PFConfig(particle_count=2048, init_cov=(0.0,) * 6, motion_cov=(0.0,) * 6,
                  res_noise_cov=(0.0,) * 6)


def _quiet(fn, *a):
    with warnings.catch_warnings():   # bursts beyond max_obs are dropped, as in the reference
        warnings.simplefilter("ignore")
        return fn(*a)


@pytest.fixture(scope="module")
def case():
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.io import workloads as jworkloads
    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.models import particle_filter as JP
    from smarc_navigation_tpu.parallel import fleet as jfleet

    tls_np, tlp_np = _quiet(workloads.combined_workload, CFG, DURATION)
    jtls, jtlp = _quiet(jworkloads.combined_workload, CFG, DURATION)
    jparams = JS.make_params(CFG)
    with pltpu.force_tpu_interpret_mode():
        _, jout = JS.run_fleet_compact(jtls, jparams, CFG)
        jout = {k: np.asarray(v) for k, v in jout.items()}
        jscalar = float(jfleet.run_combined(
            jtls, jtlp, jparams, CFG, JP.make_params(PF_CFG), PF_CFG, 2048,
            key=jax.random.PRNGKey(0)))
    params = S.make_params(CFG, device="cpu")
    tl = _quiet(workloads.slam_fleet_timelines, CFG, DURATION, 2).to("cpu")
    final_c, out_c = S.run_fleet_compact(tl, params, CFG)
    final_f, out_f = S.run_fleet(tl, params, CFG)
    return dict(tl=tl, params=params, jout=jout, jscalar=jscalar, out_c=out_c,
                out_f=out_f, final_c=final_c, final_f=final_f,
                combined=(tls_np, tlp_np))


def test_compact_matches_jax_compact(case):
    tls_np, _ = case["combined"]
    _, out = S.run_fleet_compact(tls_np.to("cpu"), case["params"], CFG)
    jout = case["jout"]
    assert set(out) == set(jout)
    for key in ("matched_mbes", "n_active"):
        np.testing.assert_array_equal(out[key].numpy(), jout[key], err_msg=key)
    np.testing.assert_allclose(out["mu"].numpy(), jout["mu"], atol=POSE_ATOL)
    assert (jout["matched_mbes"] >= 0).sum() > 4


def test_compact_matches_run_fleet(case):
    """Fleet of two missions (the event ticks are the union over both)."""
    out, ref = case["out_c"], case["out_f"]
    for key in ("matched_mbes", "n_active"):
        assert torch.equal(out[key], ref[key]), key
    np.testing.assert_allclose(out["mu"].numpy(), ref["mu"].numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(case["final_c"].mu.numpy(), case["final_f"].mu.numpy(),
                               atol=POSE_ATOL)
    assert torch.equal(case["final_c"].active, case["final_f"].active)
    # the compact replay ran the event pass only where there were events
    ev = case["tl"].events["mbes"].mask.any(dim=2).any(dim=0)
    assert 0 < int(ev.sum()) < ev.shape[0]


def test_segmented_affine_scan_matches_sequential():
    """The doubling-pass segmented scan equals the sequential composition
    (A2 A1, A2 R1 A2ᵀ + R2) restarted at every reset."""
    g = torch.Generator().manual_seed(3)
    B, T = 2, 23
    A = torch.randn(B, T, 6, 6, generator=g, dtype=torch.float64) * 0.3
    R = torch.randn(B, T, 6, 6, generator=g, dtype=torch.float64)
    reset = torch.rand(T, generator=g) < 0.3
    reset[0] = True
    As, Rs = S._segmented_affine_scan(A, R, reset)
    for t in range(T):
        if reset[t]:
            a, r = A[:, t], R[:, t]
        else:
            a = A[:, t] @ a
            r = A[:, t] @ r @ A[:, t].transpose(1, 2) + R[:, t]
        torch.testing.assert_close(As[:, t], a)
        torch.testing.assert_close(Rs[:, t], r)


def test_invalid_odometry_falls_back_to_run_fleet(case):
    tl = case["tl"]
    od = tl.channels["odom"]
    valid = od.valid.clone()
    valid[1, :3] = False
    tl_bad = dataclasses.replace(tl, channels={**tl.channels,
                                               "odom": dataclasses.replace(od, valid=valid)})
    final_c, out_c = S.run_fleet_compact(tl_bad, case["params"], CFG)
    final_f, out_f = S.run_fleet(tl_bad, case["params"], CFG)
    for key in out_f:
        assert torch.equal(out_c[key], out_f[key]), key
    assert torch.equal(final_c.Sigma, final_f.Sigma)


def test_run_combined_matches_jax(case):
    tls_np, tlp_np = case["combined"]
    got = fleet.run_combined(tls_np.to("cpu"), tlp_np.to("cpu"), case["params"], CFG,
                             P.make_params(PF_CFG, device="cpu"), PF_CFG, 2048)
    assert got.shape == () and bool(torch.isfinite(got))
    np.testing.assert_allclose(float(got), case["jscalar"],
                               rtol=1e-4, atol=1e-4 * abs(case["jscalar"]))
