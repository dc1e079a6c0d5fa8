"""Headline workload builders (numpy; port of the reference's
``io/workloads.py``): the SLAM missions at the 10 Hz ``ekf_slam.launch``
tick with simulated MBES detections that the fleet replay is timed on, the
combined PF + SLAM mission, the localization and 15-state EKF fleets, the
SAM dead-reckoning fleet and the closed-loop raycast fleet of the
reference's benchmark (``bench.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..configs import EKFLocConfig, EKFSlamConfig


def combined_slam_cfg() -> EKFSlamConfig:
    """The headline SLAM config: L=64 landmark slots, M=8 detections/burst."""
    return dataclasses.replace(
        EKFSlamConfig(),
        max_landmarks=64,
        max_obs=8,
        mhl_dist_mbes=1.0,
        q_mbes_diag=(0.1, 0.1, 0.1),
        r_diag=(1e-3,) * 6,
    )


def slam_mission_timeline(cfg: EKFSlamConfig, duration: float, seed: int):
    """One simulated SLAM mission -> numpy Timeline (odom + gps + diving
    channels, MBES detection events); bit-for-bit the reference's."""
    from ..io import sim
    from ..ops.timeline import build_timeline
    from ..utils.geometry import quat_from_rpy_np

    m = sim.simulate(
        sim.MissionSpec(
            duration_s=duration,
            num_landmarks=20,
            mbes_std=0.05,
            landmark_area_m=60.0,
            mbes_range_m=30.0,
            gps_surface_z=-100.0,
            gps_std=0.3,
            seed=seed,
        )
    )
    ticks = np.arange(0, duration + 1e-9, 1.0 / cfg.system_freq)
    gt = m.gt_at(ticks)
    quat = quat_from_rpy_np(gt[:, 3:6])
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate(
        [gt[:, 0:3], quat, m.vel_body[k], m.gyro[k]], axis=1
    )
    det = m.streams["mbes_detections"]
    gps = m.streams["gps"]
    return build_timeline(
        t0=0.0,
        t1=duration,
        freq_hz=cfg.system_freq,
        channels={
            "odom": (ticks, odom13),
            "gps": (gps["stamps"], gps["values"]),
            "diving": (ticks, np.zeros((len(ticks), 1))),
        },
        events={
            "mbes": (det["stamps"], det["values"], det["burst"], cfg.max_obs)
        },
    )


def slam_fleet_timelines(cfg: EKFSlamConfig, duration: float, B: int):
    """B-mission batched numpy SLAM Timeline: 16 distinct missions tiled to B."""
    from ..parallel import fleet

    tls = [slam_mission_timeline(cfg, duration, seed=b) for b in range(min(B, 16))]
    tls = (tls * ((B + len(tls) - 1) // len(tls)))[:B]
    return fleet.batch_timelines(tls)


def combined_workload(slam_cfg: EKFSlamConfig, duration: float, pf_seed: int = 3):
    """The combined north-star inputs, numpy-leaved: (B=1 SLAM timeline, PF
    timeline) of one mission replayed through both estimators."""
    from ..io import sim
    from ..models import particle_filter as pf

    tl_slam = slam_fleet_timelines(slam_cfg, duration, 1)
    m = sim.simulate(
        sim.MissionSpec(duration_s=duration, seed=pf_seed, gps_surface_z=-100.0)
    )
    return tl_slam, pf.pf_timeline(m, freq_hz=10.0)


def loc_fleet_timelines(cfg: EKFLocConfig, duration: float, B: int, seed: int = 7):
    """The benchmark's EKF-localization fleet (``bench.py:570-576``): one
    simulated mission (16 landmarks, DVL and MBES noise 0.05, seed 7) tiled
    to B -> (batched numpy Timeline, the mission's landmarks for
    ``ekf_localization.make_params``). Another ``seed`` gives another
    mission of the same shape."""
    from ..io import sim
    from ..models import ekf_localization as loc
    from ..parallel import fleet

    m = sim.simulate(sim.MissionSpec(duration_s=duration, num_landmarks=16, dvl_std=0.05,
                                     mbes_std=0.05, seed=seed))
    return fleet.batch_timelines([loc.loc_timeline(m, cfg)] * B), m.landmarks


def ekf15_fleet_timelines(cfg, duration: float, B: int, include_gps: bool = True,
                          seed: int = 5):
    """The benchmark's 15-state EKF fleet (``bench.py:692-694``): one
    simulated mission (seed 5; another ``seed`` gives another mission of the
    same shape) through ``ekf15_timeline`` tiled to B."""
    from ..io import sim
    from ..models import ekf_15state as e15
    from ..parallel import fleet

    m = sim.simulate(sim.MissionSpec(duration_s=duration, seed=seed))
    return fleet.batch_timelines([e15.ekf15_timeline(m, cfg, include_gps=include_gps)] * B)


def sam_dr_fleet_timelines(duration: float, B: int, seed: int = 9):
    """The benchmark's SAM dead-reckoning fleet (``bench.py:427-430``): one
    simulated mission (seed 9) through ``sam_timeline`` tiled to B."""
    from ..io import sim
    from ..models import dead_reckoning as dr
    from ..parallel import fleet

    m = sim.simulate(sim.MissionSpec(duration_s=duration, seed=seed))
    return fleet.batch_timelines([dr.sam_timeline(m)] * B)


def raycast_fleet_inputs(B: int, T: int):
    """The benchmark's closed-loop raycast fleet (``bench.py:622-645``), as
    numpy: (cfg, MBESSpec, gt_tracks (B, T, 6) f32, rocks (B, 16, 3) f32,
    rock masks (B, 16)). The config is L=32 slots, M=8; the rocks are
    ``default_rng(0)`` uniforms over a 40 × 40 × 4 m box; every mission
    flies the seed-1 30 s mission's ground truth at the 10 Hz SLAM tick."""
    from ..io import sim
    from ..ops import raycast

    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=32, max_obs=8,
        mhl_dist_mbes=1.0, q_mbes_diag=(0.1, 0.1, 0.1), r_diag=(1e-3,) * 6,
    )
    rng = np.random.default_rng(0)
    base_m = sim.simulate(sim.MissionSpec(duration_s=30.0, seed=1))
    spec = raycast.MBESSpec(num_beams=64, floor_z=-16.0, rock_radius=1.2,
                            swath_rad=2.4, max_range=40.0)
    lms = rng.uniform([0, -20, -16], [40, 20, -12], (B, 16, 3)).astype(np.float32)
    lmm = np.ones((B, 16), bool)
    ticks = np.arange(T) / cfg.system_freq
    gt = np.tile(base_m.gt_at(ticks).astype(np.float32), (B, 1, 1))
    return cfg, spec, gt, lms, lmm
