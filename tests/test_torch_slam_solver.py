"""The single-mission SLAM API's ``solver=`` and the two packages' public
signatures.

``data_associate_update``, ``step`` and ``run`` take ``solver`` at the
reference's position, before ``update_mode``, so calls written for the JAX
package bind the same way in the port: ``"device"`` solves each DA table with
the exact torch JV, anything else on the host with scipy
(``assignment.hungarian_host``), as the reference's host solver does. Each
positional call runs in both packages on the same small MBES mission (the
JAX side on the CPU, where its host solver's ``pure_callback`` runs). The
public signatures of the SLAM modules, and those of the multi-device layer
(``parallel/mesh.py``, ``parallel/resample_dist.py`` and the functions that
take ``pmesh=`` / ``device_mesh=``), are compared by AST.

Tolerances: associations (matched, n_active) are exact; poses agree to
1e-3 and Σ's pose diagonal to 1e-3 relative, the bounds of
``tests/test_torch_ekf_slam.py`` for the same dense path.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import assignment
from smarc_navigation_tpu_torch.ops import timeline as ptl
from smarc_navigation_tpu_torch.utils.geometry import quat_from_rpy_np

REPO = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=8, max_obs=4, mhl_dist_mbes=1.0,
    q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
DURATION = 2.0
POSE_ATOL = 1e-3


def _raw_mission(seed):
    m = sim.simulate(sim.MissionSpec(
        duration_s=DURATION, num_landmarks=12, mbes_std=0.05, landmark_area_m=50.0,
        mbes_range_m=30.0, gps_surface_z=-100.0, seed=seed))
    ticks = np.arange(0, DURATION + 1e-9, 1.0 / CFG.system_freq)
    gt = m.gt_at(ticks)
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate(
        [gt[:, 0:3], quat_from_rpy_np(gt[:, 3:6]), m.vel_body[k], m.gyro[k]], axis=1)
    det = m.streams["mbes_detections"]
    return dict(t0=0.0, t1=DURATION, freq_hz=CFG.system_freq,
                channels={"odom": (ticks, odom13)},
                events={"mbes": (det["stamps"], det["values"], det["burst"], CFG.max_obs)})


@pytest.fixture(scope="module")
def mission():
    import jax.numpy as jnp

    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.ops.timeline import build_timeline

    raw = _raw_mission(1)
    tl = ptl.build_timeline(**raw).to("cpu")
    mbes = tl.events["mbes"].mask.any(1).numpy()
    # the last tick with a burst, and a state from the replay before it
    k = int(np.flatnonzero(mbes)[-1])
    params = S.make_params(CFG, device="cpu")
    st, _ = S.run(tl.map(lambda x: x[:k]), params, CFG)
    return dict(JS=JS, jnp=jnp, tl=tl, jtl=build_timeline(**raw), params=params,
                jparams=JS.make_params(CFG), k=k, st=st,
                jst=JS.SlamState(*(jnp.asarray(x.numpy()) for x in st)))


def _assert_state_close(st, jst):
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(jst.active))
    assert int(st.n_active) == int(jst.n_active)
    np.testing.assert_allclose(st.mu.numpy(), np.asarray(jst.mu), atol=POSE_ATOL)
    np.testing.assert_allclose(np.diagonal(st.Sigma.numpy())[:6],
                               np.diagonal(np.asarray(jst.Sigma))[:6], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("solver", ["device", "host"])
def test_run_binds_solver_positionally(mission, solver):
    """``run(tl, params, cfg, s0, solver)`` as the reference is called."""
    JS = mission["JS"]
    s0 = S.init_state(CFG, device="cpu")
    final, out = S.run(mission["tl"], mission["params"], CFG, s0, solver)
    jfinal, jout = JS.run(mission["jtl"], mission["jparams"], CFG, JS.init_state(CFG), solver)
    for key in ("matched_mbes", "n_active"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]), err_msg=key)
    assert int((out["matched_mbes"] >= 0).sum()) > 0
    np.testing.assert_allclose(out["mu"].numpy(), np.asarray(jout["mu"]), atol=POSE_ATOL)
    _assert_state_close(final, jfinal)


@pytest.mark.parametrize("solver", ["device", "host"])
def test_step_binds_solver_and_update_mode_positionally(mission, solver):
    """``step(cfg, params, state, tick, solver, "marginal")``: a positional
    update mode after the solver reaches the marginal writeback in both
    packages."""
    import jax

    JS = mission["JS"]
    k = mission["k"]
    st, out = S.step(CFG, mission["params"], mission["st"], mission["tl"].slice_tick(k),
                     solver, "marginal")
    jtick = jax.tree_util.tree_map(lambda x: x[k], mission["jtl"])
    jst, jout = JS.step(CFG, mission["jparams"], mission["jst"], jtick, solver, "marginal")
    np.testing.assert_array_equal(out["matched_mbes"].numpy(), np.asarray(jout["matched_mbes"]))
    assert int((out["matched_mbes"] >= 0).sum()) > 0
    _assert_state_close(st, jst)
    # the marginal writeback, not the full update
    full, _ = S.step(CFG, mission["params"], mission["st"], mission["tl"].slice_tick(k),
                     solver, "full")
    assert not torch.equal(full.Sigma, st.Sigma)


@pytest.mark.parametrize("solver", ["device", "host"])
def test_data_associate_update_binds_solver_positionally(mission, solver):
    JS = mission["JS"]
    jnp = mission["jnp"]
    k = mission["k"]
    ev = mission["tl"].events["mbes"]
    z, zm = ev.value[k], ev.mask[k]
    st, ctr = S.data_associate_update(mission["st"], z, zm, mission["params"], CFG, S.MBES,
                                      solver, "full")
    jst, jctr = JS.data_associate_update(mission["jst"], jnp.asarray(z.numpy()),
                                         jnp.asarray(zm.numpy()), mission["jparams"], CFG,
                                         JS.MBES, solver, "full")
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(jctr))
    _assert_state_close(st, jst)


@pytest.mark.parametrize("R,C", [(8, 3), (12, 12), (40, 8), (5, 1), (70, 30)])
def test_hungarian_host_matches_hungarian(R, C):
    """On continuous costs (a unique optimum) the host solve is the torch
    JV's assignment, on the cost's device, and scipy's optimum."""
    rng = np.random.default_rng(R * 100 + C)
    cost = torch.from_numpy(rng.uniform(0.0, 10.0, (R, C)).astype(np.float32))
    got = assignment.hungarian_host(cost)
    assert got.dtype == torch.int32 and got.shape == (C,) and got.device == cost.device
    assert torch.equal(got, assignment.hungarian(cost))
    r, c = linear_sum_assignment(cost.double().numpy())
    np.testing.assert_array_equal(got.numpy()[c], r)


def test_hungarian_host_leaves_columns_past_the_rows_unassigned():
    cost = torch.tensor([[1.0, 5.0, 2.0], [4.0, 1.0, 3.0]])
    got = assignment.hungarian_host(cost)
    np.testing.assert_array_equal(got.numpy(), [0, 1, -1])


# ---------------------------------------------------------------------------
# the public signatures of the two packages' SLAM modules
# ---------------------------------------------------------------------------

# deliberate differences, by function: the parameters the port adds (a
# device for the entry points that make tensors, and the trailing
# graph= of the fleet replays and the fleet pass's hoisted
# constants). The reference's TPU layout options and JAX keys are in
# functions the port does not share by name.
ADDED = {
    ("models/ekf_slam.py", "make_params"): ["device"],
    ("models/ekf_slam.py", "init_state"): ["device"],
    ("models/ekf_slam.py", "run_fleet"): ["graph"],
    ("models/ekf_slam.py", "run_fleet_marginal"): ["graph"],
    ("models/ekf_slam.py", "da_lanes_pass"): ["consts"],
    ("models/ekf_slam.py", "da_lanes_pass_marginal"): ["consts"],
}


# the multi-device layer: whole modules, and the functions that take a mesh
MESH_FUNCTIONS = {
    "parallel/mesh.py": None,
    "parallel/resample_dist.py": None,
    "models/particle_filter.py": ("fleet_update_resample", "update_resample", "step",
                                  "run_fast_segmented", "run_fast", "run"),
    "parallel/fleet.py": ("fleet_step", "run_fleet", "run_raycast_fleet"),
}
ADDED.update({
    ("models/particle_filter.py", "fleet_update_resample"): ["u", "noise", "scheme"],
    ("models/particle_filter.py", "update_resample"): ["u", "noise"],
    ("parallel/fleet.py", "run_fleet"): ["graph"],
    ("parallel/fleet.py", "run_raycast_fleet"): ["graph"],
})
# the port takes a torch.Generator, or the systematic uniform itself, where
# the reference takes a JAX PRNG key, in the key's place
RENAMED = {"key": ("generator", "u"), "keys": ("u",)}


def _signatures(path: Path) -> dict:
    """{public function: [parameter names in order]} of a module's top level."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            a = node.args
            out[node.name] = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return out


@pytest.mark.parametrize("module", ["models/ekf_slam.py", "ops/slam_da_kernels.py"])
def test_public_signatures_match_the_reference(module):
    """Every public function the port shares with the reference takes the
    reference's parameters in the reference's order, so positional calls
    bind alike; the port's own additions follow them."""
    ref = _signatures(REPO / "smarc_navigation_tpu" / module)
    port = _signatures(REPO / "smarc_navigation_tpu_torch" / module)
    shared = sorted(set(ref) & set(port))
    assert {"da_lanes", "hungarian_lanes"} <= set(shared) or {"step", "run"} <= set(shared)
    for name in shared:
        added = ADDED.get((module, name), [])
        # the additions come after every parameter of the reference
        assert port[name] == ref[name] + added, (name, port[name], ref[name])


@pytest.mark.parametrize("module", sorted(MESH_FUNCTIONS))
def test_mesh_signatures_match_the_reference(module):
    """The multi-device entry points keep the reference's parameters in the
    reference's order (a key's place taken by the port's generator or
    uniform), the port's additions after them."""
    ref = _signatures(REPO / "smarc_navigation_tpu" / module)
    port = _signatures(REPO / "smarc_navigation_tpu_torch" / module)
    names = MESH_FUNCTIONS[module] or sorted(ref)
    for name in names:
        assert name in port, (module, name)
        want = ref[name] + ADDED.get((module, name), [])
        got = port[name]
        assert len(got) == len(want), (name, got, want)
        for g, w in zip(got, want):
            assert g == w or g in RENAMED.get(w, ()), (name, got, want)
