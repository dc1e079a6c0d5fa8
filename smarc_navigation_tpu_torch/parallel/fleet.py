"""Monte-Carlo mission fleets on one device (PyTorch port of
``smarc_navigation_tpu/parallel/fleet.py``).

* ``init_fleet`` / ``fleet_step`` / ``run_fleet``: the SLAM + PF mission
  fleet, every mission an independent pair of filters. The SLAM half is the
  tick of ``ekf_slam.run_fleet`` (K1 + K2 per event pass, the same
  function as the reference's vmapped ``slam.step``); the PF half steps
  every bank at once (``pf.fleet_predict``, ``pf.fleet_update_resample`` in
  any scheme, ``pf.estimate``), each mission drawing under its own key of
  the counter-based generator, split from ``seed`` in place of
  ``jax.random.split``: the card and the CPU draw the same bits. On CUDA
  tensors ``run_fleet``'s tick loop runs as a cached CUDA graph.
* ``run_raycast_fleet``: the fully closed-loop fleet: per tick and mission
  an MBES ping rendered against the mission's rock field, its detections,
  and the SLAM update. On CUDA tensors the kernel path (the batched predict,
  then ``ekf_slam.da_lanes_pass``: K1, K2's phase 1, K12) runs its T-tick
  loop as a cached CUDA graph (``utils.graphs``).
* ``batch_timelines`` and the combined PF + SLAM mission ``run_combined``.

Mission sharding (``device_mesh=``, a ``parallel.mesh.Mesh``): the
missions split over the mesh's ``mission`` axis and each mission shard
replays its missions on the first device of its mesh row; in
``run_fleet`` each bank's particles split over the ``particle`` axis too:
the predict runs per particle shard (draws keyed on the global particle
index) and the GPS update through ``pf.fleet_update_resample(pmesh=...)``
(the distributed resample where the shards tile by CDF_BLOCK), which forces
the systematic scheme, as the reference. Outputs are joined on the caller's
device, bitwise the unsharded runs' (the particle-sharded fleet's against
``pf_scheme="systematic"``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import EKFSlamConfig, PFConfig
from ..models import ekf_slam as slam
from ..models import particle_filter as pf
from ..ops import raycast
from ..ops.timeline import Timeline
from ..utils import graphs
from ..utils.geometry import odom_pose
from . import mesh as mesh_lib


def _structure(tl: Timeline):
    return (tuple(tl.channels), tuple(tl.windows), tuple(tl.events))


def batch_timelines(timelines: list) -> Timeline:
    """Stack per-mission numpy-leaved Timelines into one batched Timeline
    (leading mission axis B) on the host; ``.to(device)`` ships it.

    Every timeline must have the same channels and the same leaf shapes and
    dtypes as the first — checked for ALL of them, so a mismatched mission
    raises here instead of surfacing as a broadcast error mid-replay."""
    if not timelines:
        raise ValueError("batch_timelines needs at least one timeline")
    first = timelines[0]
    ref = [(np.shape(x), np.asarray(x).dtype) for x in first.leaves()]
    for b, tl in enumerate(timelines[1:], start=1):
        if _structure(tl) != _structure(first) or tl.dt != first.dt:
            raise ValueError(
                f"timeline {b} has channels {_structure(tl)} / dt {tl.dt}, "
                f"timeline 0 has {_structure(first)} / dt {first.dt}")
        got = [(np.shape(x), np.asarray(x).dtype) for x in tl.leaves()]
        if got != ref:
            raise ValueError(
                f"timeline {b} leaf shapes/dtypes {got} differ from "
                f"timeline 0's {ref}")
    leaves_per_tl = [tl.leaves() for tl in timelines]
    stacked = iter([np.stack(xs, axis=0) for xs in zip(*leaves_per_tl)])
    return first.map(lambda _x: next(stacked))


# ---------------------------------------------------------------------------
# the SLAM + PF mission fleet
# ---------------------------------------------------------------------------

class FleetState(NamedTuple):
    slam: slam.SlamState       # batched (B, ...)
    pf: pf.FleetPFState        # particles (B, 6, N), key (B,), t_prev (B,)


def init_fleet(
    batch: int,
    n_particles: int,
    slam_cfg: EKFSlamConfig,
    pf_params: pf.PFParams,
    pf_cfg: PFConfig,
    seed: int = 0,
) -> FleetState:
    """The fleet's initial state on the device of ``pf_params``: the SLAM
    initial state for every mission, and each mission's particle bank drawn
    under its own key (``pf.fleet_init``)."""
    dev = pf_params.init_cov.device
    s0 = slam.init_state(slam_cfg, dtype=pf_params.init_cov.dtype, device=dev)
    slam_b = slam.SlamState(*(x.expand((batch,) + x.shape).contiguous() for x in s0))
    return FleetState(slam=slam_b, pf=pf.fleet_init(batch, n_particles, pf_params, seed))


def _predict_sharded(state: pf.FleetPFState, odom, ticks, fresh, params: pf.PFParams, pmesh):
    """``pf.fleet_predict`` per particle shard of ``pmesh``'s first row
    (each shard's draws keyed on its global particle indices), the banks
    joined back on their device: bitwise the unsharded predict."""
    row = pmesh.row(0)
    P_ = row.shape[mesh_lib.PARTICLE_AXIS]
    ns = state.particles.shape[-1] // P_
    bank = mesh_lib.particle_sharding(row, 3, 2)
    rest = mesh_lib.replicate((state.key, state.t_prev, odom, ticks, fresh, params), row)
    out = [pf.fleet_predict(pf.FleetPFState(p, key, t_prev), o, t, f, prm, idx_off=i * ns)
           for i, (p, (key, t_prev, o, t, f, prm)) in enumerate(zip(bank.shard(state.particles)[0],
                                                                     rest))]
    dev = state.particles.device
    return pf.FleetPFState(particles=bank.join([[o.particles for o in out]], dev),
                           key=out[0].key.to(dev), t_prev=out[0].t_prev.to(dev))


def _pf_tick(params: pf.PFParams, state: pf.FleetPFState, odom, fresh, ticks, gps_xy, do_upd,
             scheme: str, pmesh=None):
    """One PF tick of every mission: the predict where the odometry is
    fresh, the GPS update and resample where a fix arrives off the dive,
    then the estimate; per mission the reference's ``pf.step``, for the
    whole fleet at once. With ``pmesh`` the predict runs per particle shard
    and the update through the fleet's distributed resample. No host sync,
    but for that resample's fit check."""
    if pmesh is None:
        pred = pf.fleet_predict(state, odom, ticks, fresh, params)
    else:
        pred = _predict_sharded(state, odom, ticks, fresh, params, pmesh)
    upd = pf.fleet_update_resample(pred, gps_xy, params, pmesh=pmesh, scheme=scheme)
    parts = torch.where(do_upd[:, None, None], upd.particles, pred.particles)
    new = pf.FleetPFState(particles=parts, key=torch.where(do_upd, upd.key, pred.key),
                          t_prev=pred.t_prev)
    mean, cov = pf.estimate(parts)
    return new, {"mean": mean, "cov": cov, "updated": do_upd}


def _pf_tick_inputs(tick_batch) -> tuple:
    """(odom (..., 13), fresh, ticks, GPS fix (..., 2), update flag) of a
    batched tick or timeline."""
    ch = tick_batch.channels
    do_upd = ch["gps"].fresh & (ch["diving"].value[..., 0] < 0.5)
    return (ch["odom"].value, ch["odom"].fresh, tick_batch.ticks, ch["gps"].value[..., 0:2],
            do_upd)


def fleet_step(
    slam_cfg: EKFSlamConfig,
    slam_params: slam.SlamParams,
    pf_cfg: PFConfig,
    pf_params: pf.PFParams,
    state: FleetState,
    tick_batch,  # per-mission tick slices, leading axis B
    pf_scheme: str = "residual",
    pf_pmesh=None,
):
    """One navigation tick for every mission in the fleet: the SLAM tick of
    ``ekf_slam.run_fleet`` (the batched predict, then K1 + K2 per event
    sensor) and the PF tick of every bank at once (``pf_scheme`` is the
    resampler; ``"systematic"`` is the reference's fleet-wide
    ``fleet_update_resample``, the others its per-mission ``pf.step``).
    ``pf_pmesh``: a mesh whose particle axis shards every bank (the
    systematic scheme only)."""
    if pf_pmesh is not None and pf_scheme != "systematic":
        raise ValueError("particle-axis sharding (pf_pmesh) requires the systematic scheme "
                         "(the distributed resample implements it)")
    odom = tick_batch.channels["odom"]
    names = tuple(n for n in ("mbes", "fls") if n in tick_batch.events)
    consts = {n: slam.pass_consts(slam_params, slam_cfg, slam._SENSORS[n]) for n in names}
    events = {n: (tick_batch.events[n].value, tick_batch.events[n].mask & odom.valid[:, None])
              for n in names}
    band = slam.initial_band(state.slam.Sigma, slam_cfg.max_landmarks)
    sl, _band, sl_out = slam._full_tick(
        state.slam, band, odom_pose(odom.value), odom.valid, events, slam_params, slam_cfg,
        consts, slam.a8_consts(slam_params.R, slam_params.R.dtype))
    sl_out["sigma_diag6"] = torch.diagonal(sl.Sigma[:, 0:6, 0:6], dim1=1, dim2=2)
    pf2, pf_out = _pf_tick(pf_params, state.pf, *_pf_tick_inputs(tick_batch), pf_scheme,
                           pf_pmesh)
    return FleetState(slam=sl, pf=pf2), {"slam": sl_out, "pf": pf_out}


def _fleet_inputs(timelines: Timeline, slam_cfg: EKFSlamConfig, slam_params: slam.SlamParams,
                  pf_params: pf.PFParams, pf0: pf.FleetPFState):
    """Every tensor ``_fleet_loop`` reads, as a flat dict, and the event
    sensor names: the SLAM loop's inputs (``ekf_slam._loop_inputs``), the
    PF's per-tick (T, B, ...) inputs, its parameters and initial banks."""
    inp, names = slam._loop_inputs(timelines, slam_params, slam_cfg)
    for k, x in zip(("odom", "fresh", "ticks", "gps", "upd"), _pf_tick_inputs(timelines)):
        inp["pf_" + k] = x.transpose(0, 1).contiguous()
    inp.update(("pfp_" + k, v) for k, v in pf_params._asdict().items())
    inp.update(("pf0_" + k, v) for k, v in pf0._asdict().items())
    return inp, names


def _fleet_loop(inp: dict, slam_cfg: EKFSlamConfig, names: tuple, scheme: str, pmesh=None):
    """``run_fleet``'s tick loop on ``_fleet_inputs`` -> (final FleetState,
    outputs stacked (T, B, ...)). Capture-safe where the PF takes no
    distributed resample: nothing in it then syncs with the host or builds
    a tensor from host data."""
    params, s0, consts, c12 = slam._loop_setup(inp, names)
    pfp = pf.PFParams(*(inp["pfp_" + k] for k in pf.PFParams._fields))
    T, B = inp["valid"].shape
    sl = slam.SlamState(*(x.expand((B,) + x.shape).contiguous() for x in s0))
    band = inp["band0"].expand(B, 24, slam_cfg.max_landmarks).contiguous()
    pfs = pf.FleetPFState(*(inp["pf0_" + k] for k in pf.FleetPFState._fields))
    outs = []
    for t in range(T):
        sl, band, sl_out = slam._full_tick(sl, band, inp["odom_pose"][t], inp["valid"][t],
                                           slam._tick_events(inp, names, t), params, slam_cfg,
                                           consts, c12)
        sl_out["sigma_diag6"] = torch.diagonal(sl.Sigma[:, 0:6, 0:6], dim1=1, dim2=2)
        pfs, pf_out = _pf_tick(pfp, pfs, *(inp["pf_" + k][t] for k in
                                           ("odom", "fresh", "ticks", "gps", "upd")), scheme,
                              pmesh)
        outs.append({"slam": sl_out, "pf": pf_out})
    stacked = {part: {k: torch.stack([o[part][k] for o in outs]) for k in outs[0][part]}
               for part in outs[0]}
    return FleetState(slam=sl, pf=pfs), stacked


def run_fleet(
    timelines: Timeline,          # batched, tensor leaves (B, T, ...)
    slam_cfg: EKFSlamConfig,
    slam_params: slam.SlamParams,
    pf_cfg: PFConfig,
    pf_params: pf.PFParams,
    n_particles: int,
    device_mesh=None,
    seed: int = 0,
    pf_scheme: str | None = None,
    graph: bool = True,
):
    """Replay the whole fleet -> (final FleetState, outputs stacked
    time-major (T, B, ...)). ``pf_scheme`` defaults to the reference's
    residual sampler (``auv_pf.py:169-198``).

    On CUDA tensors the tick loop runs as a CUDA graph cached per
    configuration, scheme and shapes (``utils.graphs``; the reference's
    jitted ``lax.scan``); ``graph=False`` runs it eagerly. The initial
    banks are drawn before the loop, from ``seed``.

    ``device_mesh``: missions split over its ``mission`` axis, one replay
    per mission shard on the first device of its row. Where its
    ``particle`` axis is wider than 1, each bank's particles split over it
    and the scheme defaults to (and must be) systematic, as the
    reference's. A mission shard's loop is graphed where its particle
    shards share one card and the update takes no distributed resample
    (whose fit check syncs with the host), else eager."""
    B = timelines.ticks.shape[0]
    P_ = 1 if device_mesh is None else device_mesh.shape[mesh_lib.PARTICLE_AXIS]
    if pf_scheme is None:
        pf_scheme = "systematic" if P_ > 1 else "residual"
    if P_ > 1 and pf_scheme != "systematic":
        raise ValueError("particle-axis sharding requires the systematic scheme")
    pf0 = pf.fleet_init(B, n_particles, pf_params, seed)
    if device_mesh is None:
        return _run_fleet_shard(timelines, slam_cfg, slam_params, pf_params, pf0, pf_scheme,
                                None, graph)
    M = device_mesh.shape[mesh_lib.MISSION_AXIS]
    if B % M:
        raise ValueError(f"fleet size {B} not divisible by mission axis {M}")
    if n_particles % P_:
        raise ValueError(f"particle count {n_particles} not divisible by particle axis {P_}")
    res = []
    for m, (tl, p0) in enumerate(zip(mesh_lib.shard_missions(timelines, device_mesh),
                                     mesh_lib.shard_missions(pf0, device_mesh))):
        d = device_mesh.devices[m][0]
        sp, pp = mesh_lib.tree_map(lambda x: x.to(d), (slam_params, pf_params))
        res.append(_run_fleet_shard(tl, slam_cfg, sp, pp, p0, pf_scheme,
                                    device_mesh.row(m) if P_ > 1 else None, graph))
    dev = timelines.ticks.device
    return (mesh_lib.join_missions([r[0] for r in res], dev, 0),
            mesh_lib.join_missions([r[1] for r in res], dev, 1))


def _run_fleet_shard(timelines, slam_cfg, slam_params, pf_params, pf0, scheme, pmesh, graph):
    """``run_fleet``'s replay of one set of missions from its initial banks
    ``pf0``, the banks' particles split over ``pmesh`` (a 1 x P mesh) or
    whole (None)."""
    inp, names = _fleet_inputs(timelines, slam_cfg, slam_params, pf_params, pf0)
    dev = inp["valid"].device
    capture_safe = pmesh is None or (
        set(pmesh.devices[0]) == {dev}
        and not pf._uses_dist_resample(pmesh, pf0.particles.shape[-1]))
    if graph and dev.type == "cuda" and capture_safe:
        P_ = 1 if pmesh is None else pmesh.shape[mesh_lib.PARTICLE_AXIS]
        key = ("fleet.run_fleet", slam_cfg, names, scheme, P_)
        return graphs.run(key, lambda x: _fleet_loop(x, slam_cfg, names, scheme, pmesh), inp)
    return _fleet_loop(inp, slam_cfg, names, scheme, pmesh)


# ---------------------------------------------------------------------------
# the combined PF + SLAM mission
# ---------------------------------------------------------------------------

def run_combined(
    tl_slam: Timeline,            # batched (B=1) SLAM timeline, tensor leaves
    tl_pf: Timeline,              # single-mission PF timeline, tensor leaves
    slam_params: slam.SlamParams,
    slam_cfg: EKFSlamConfig,
    pf_params: pf.PFParams,
    pf_cfg: PFConfig,
    n_particles: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One mission replayed through both estimators on their kernel paths:
    the particle bank through the segmented multi-tick predict
    (``particle_filter.run`` with ``use_pallas=True``: K5 + K7) and the
    EKF-SLAM filter through the event-compacted path
    (``ekf_slam.run_fleet_compact``: K1 + K2 on event ticks only). Returns
    one scalar that depends on both outputs."""
    _final_pf, out_pf = pf.run(
        tl_pf, pf_params, pf_cfg, n_particles=n_particles, generator=generator,
        scheme="systematic", use_pallas=True)
    final_s, _out_s = slam.run_fleet_compact(tl_slam, slam_params, slam_cfg)
    return (torch.sum(out_pf["mean"]) + torch.sum(final_s.mu[:, 0:6])
            + torch.sum(final_s.n_active))


# ---------------------------------------------------------------------------
# the closed-loop raycast fleet
# ---------------------------------------------------------------------------

def _raycast_inputs(gt_tracks, landmark_sets, lm_masks, cfg: EKFSlamConfig,
                    params: slam.SlamParams, spec: raycast.MBESSpec) -> dict:
    """Every tensor the raycast tick loop reads, as a flat dict (a graphed
    replay copies exactly these into its static buffers): the time-major
    poses, the rock fields, the beam directions and index, the initial state
    and band, the parameters and the MBES pass constants."""
    dev, dt = gt_tracks.device, params.R.dtype
    B = gt_tracks.shape[0]
    s0 = slam.init_state(cfg, dtype=dt, device=dev)
    c = slam.pass_consts(params, cfg, slam.MBES)
    inp = {"poses": gt_tracks.to(dt).transpose(0, 1).contiguous(),
           "lms": landmark_sets.to(dt).contiguous(), "lmm": lm_masks.contiguous(),
           "dirs": raycast.beam_dirs_base(spec, dt, dev),
           "beam_idx": torch.arange(spec.num_beams, device=dev),
           "valid": torch.ones(B, dtype=torch.bool, device=dev),
           "band0": slam.initial_band(s0.Sigma, cfg.max_landmarks),
           "new_cov_mbes": c.new_cov, "outlier": c.outlier, "mh_dist_mbes": c.mh_dist}
    inp.update(("p_" + k, v) for k, v in params._asdict().items() if v is not None)
    inp.update(("s0_" + k, v) for k, v in s0._asdict().items())
    return inp


def _raycast_loop(inp: dict, cfg: EKFSlamConfig, spec: raycast.MBESSpec):
    """The kernel path's tick loop on ``_raycast_inputs`` -> (final state,
    (mu (B, T, 6), n_active (B, T))). Per tick: the batched render and
    detections, the batched predict (Σ included: A S Aᵀ + R, A S), then
    ``da_lanes_pass`` (K1, phase 1, K12) with the band carried.
    Capture-safe: nothing in it syncs with the host or builds a tensor from
    host data."""
    params, s0, consts, c12 = slam._loop_setup(inp, ("mbes",))
    T, B = inp["poses"].shape[:2]
    L = cfg.max_landmarks
    state = slam.SlamState(*(x.expand((B,) + x.shape).contiguous() for x in s0))
    band = inp["band0"].expand(B, 24, L).contiguous()
    mus, nacts = [], []
    for t in range(T):
        pose = inp["poses"][t]
        pts, mask = raycast.ping_detections(pose, inp["lms"], inp["lmm"], spec, cfg.max_obs,
                                            dirs=inp["dirs"], idx=inp["beam_idx"])
        pred, _ = slam._fleet_predict(state, pose, inp["valid"], params, predict_sigma=True,
                                      c12=c12)
        state, _m, band = slam.da_lanes_pass(pred, pts, mask, params, cfg, slam.MBES, band=band,
                                             consts=consts["mbes"])
        mus.append(state.mu[:, 0:6])
        nacts.append(state.n_active)
    return state, (torch.stack(mus, 1), torch.stack(nacts, 1))


def _raycast_dense(gt_tracks, landmark_sets, lm_masks, cfg: EKFSlamConfig,
                   params: slam.SlamParams, spec: raycast.MBESSpec):
    """The kernel-less path: per mission, per tick ``predict`` and
    ``data_associate_update`` on the rendered detections."""
    dev, dt = gt_tracks.device, params.R.dtype
    dirs = raycast.beam_dirs_base(spec, dt, dev)
    beam_idx = torch.arange(spec.num_beams, device=dev)
    finals, mus, nacts = [], [], []
    for b in range(gt_tracks.shape[0]):
        st = slam.init_state(cfg, dtype=dt, device=dev)
        mu_b, na_b = [], []
        for pose in gt_tracks[b].to(dt):
            pts, mask = raycast.ping_detections(pose, landmark_sets[b].to(dt), lm_masks[b], spec,
                                                cfg.max_obs, dirs=dirs, idx=beam_idx)
            pred = slam.predict(st, pose, params)
            st, _ = slam.data_associate_update(pred, pts, mask, params, cfg, slam.MBES)
            mu_b.append(st.mu[0:6])
            na_b.append(st.n_active)
        finals.append(st)
        mus.append(torch.stack(mu_b))
        nacts.append(torch.stack(na_b))
    final = slam.SlamState(*(torch.stack(xs) for xs in zip(*finals)))
    return final, (torch.stack(mus), torch.stack(nacts))


def run_raycast_fleet(
    gt_tracks: torch.Tensor,      # (B, T, 6) per-mission vehicle trajectories
    landmark_sets: torch.Tensor,  # (B, L', 3) per-mission true rock fields
    lm_masks: torch.Tensor,       # (B, L')
    slam_cfg: EKFSlamConfig,
    slam_params: slam.SlamParams,
    mbes_spec=None,
    device_mesh=None,
    use_da_kernel: bool | None = None,
    graph: bool = True,
):
    """Fully closed-loop Monte-Carlo fleet: per tick and mission, render an
    MBES ping against the mission's rock field (``ops.raycast``), extract
    detections (``ops.sonar``) and run the SLAM update, with no host in the
    loop. Returns (final SlamStates (B, ...), (mu (B, T, 6), n_active
    (B, T))).

    ``use_da_kernel`` (default: True for CUDA tensors, False for CPU ones,
    as the reference takes its kernel path on its accelerator): True runs
    the batched render and predict, then ``ekf_slam.da_lanes_pass`` (K1,
    phase 1, K12) every tick, on CPU tensors through the kernels' plain
    versions; False the per-mission ``predict`` + ``data_associate_update``.
    On CUDA tensors the kernel path's tick loop runs as a CUDA graph cached
    per configuration, MBES spec and shapes; ``graph=False`` runs it
    eagerly.

    ``device_mesh``: the missions split over its ``mission`` axis, each
    mission shard replayed on the first device of its mesh row (no
    collectives: the missions are independent), the results joined on the
    caller's device: bitwise the unsharded run."""
    spec = raycast.MBESSpec() if mbes_spec is None else mbes_spec
    if device_mesh is not None:
        M = device_mesh.shape[mesh_lib.MISSION_AXIS]
        if gt_tracks.shape[0] % M:
            raise ValueError(f"fleet size {gt_tracks.shape[0]} not divisible by "
                             f"mission axis {M}")
        res = []
        for m, (gt, lms, lmm) in enumerate(mesh_lib.shard_missions(
                (gt_tracks, landmark_sets, lm_masks), device_mesh)):
            prm = mesh_lib.tree_map(lambda x, d=device_mesh.devices[m][0]: x.to(d), slam_params)
            res.append(run_raycast_fleet(gt, lms, lmm, slam_cfg, prm, spec,
                                         use_da_kernel=use_da_kernel, graph=graph))
        return mesh_lib.join_missions(res, gt_tracks.device, 0)
    on_card = gt_tracks.device.type == "cuda"
    if use_da_kernel is None:
        use_da_kernel = on_card
    if not use_da_kernel:
        return _raycast_dense(gt_tracks, landmark_sets, lm_masks, slam_cfg, slam_params, spec)
    inp = _raycast_inputs(gt_tracks, landmark_sets, lm_masks, slam_cfg, slam_params, spec)
    if graph and on_card:
        key = ("fleet.run_raycast_fleet", slam_cfg, tuple(spec))
        return graphs.run(key, lambda x: _raycast_loop(x, slam_cfg, spec), inp)
    return _raycast_loop(inp, slam_cfg, spec)
