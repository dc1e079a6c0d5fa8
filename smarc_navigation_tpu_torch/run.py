"""Mission replay CLI — the experiment harness (port of
``smarc_navigation_tpu/run.py``).

Replaces the reference's roslaunch entry points + batch runner
(``*/launch/*.launch``, ``pf_loop.py``): one command simulates (or loads) a
mission, replays the requested filter stack on the card (``--device``,
default ``cuda``; it raises where there is no CUDA device, and never falls
back to the CPU unless asked with ``--device cpu``), and writes a run report
+ error dashboard.

    python -m smarc_navigation_tpu_torch.run demo --duration 60 --out /tmp/demo
    python -m smarc_navigation_tpu_torch.run pf --particles 1048576 --pallas
    python -m smarc_navigation_tpu_torch.run replay --log data/sample_mission.npz

Each handler prints its report as the reference does and returns it;
``main`` returns what the handler returns. Wall times are taken after
``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def _clock(dev) -> float:
    """perf_counter after the device's queued work has finished."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _wrote(out: str, names: tuple) -> str:
    from .io import observability

    if "dashboard.png" in names and not observability.have_matplotlib():
        rest = " and ".join(n for n in names if n != "dashboard.png")
        return f"wrote {out}/{rest} (dashboard.png skipped: matplotlib is not installed)"
    return f"wrote {out}/" + " and ".join(names)


def _demo(args):
    import numpy as np

    from .configs import EKFSlamConfig
    from .io import observability, sim
    from .models import dead_reckoning as dr
    from .models import ekf_slam as slam

    dev = _device(args.device)
    m = sim.simulate(
        sim.MissionSpec(
            duration_s=args.duration, num_landmarks=20, mbes_std=0.05,
            dvl_std=0.02, imu_rpy_std=0.002, landmark_area_m=60.0,
            mbes_range_m=30.0, seed=args.seed,
        )
    )
    os.makedirs(args.out, exist_ok=True)

    # dead-reckoning chain (the closed-form replay)
    tl_dr = dr.sam_timeline(m).to(dev)
    t0 = _clock(dev)
    track_dr = dr.run_sam_dr_vectorized(tl_dr)
    dt_dr = _clock(dev) - t0
    del track_dr

    # SLAM chain on odometry from the LoLo provider
    tlo = dr.odom_timeline(m).to(dev)
    gt0 = m.gt_at(np.asarray([0.0]))[0]  # gt init (odom_provider.cpp:261-284)
    odom = dr.run_odom_provider(tlo, init_pose=gt0.astype(np.float32)).cpu().numpy()
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=64, max_obs=8, mhl_dist_mbes=1.0,
        q_mbes_diag=(0.1, 0.1, 0.1), r_diag=(1e-3,) * 6,
    )
    ticks_s = np.arange(0, args.duration + 1e-9, 1.0 / cfg.system_freq)
    idx = np.clip((ticks_s * 30.0).astype(int), 0, len(odom) - 1)
    tl_s = slam.slam_timeline(m, odom[idx], ticks_s, cfg).to(dev)
    params = slam.make_params(cfg, device=dev)
    t0 = _clock(dev)
    final, out = slam.run(tl_s, params, cfg)
    dt_slam = _clock(dev) - t0

    gt_s = m.gt_at(ticks_s)
    mu = out["mu"].cpu().numpy()
    stats = observability.error_dashboard(
        ticks_s,
        {"odometry": odom[idx][:, :6], "ekf_slam": mu},
        gt_s,
        path=os.path.join(args.out, "dashboard.png"),
    )
    rep = observability.run_report(
        mu, gt_s,
        extra={
            "n_landmarks_mapped": int(final.n_active),
            "dr_wall_s": dt_dr,
            "slam_wall_s": dt_slam,
            "slam_realtime_factor": args.duration / dt_slam,
        },
        path=os.path.join(args.out, "report.json"),
        device=dev,
    )
    result = {"stats": stats, "report": rep}
    print(json.dumps(result, indent=2))
    print(_wrote(args.out, ("dashboard.png", "report.json")))
    return result


def _pf(args):
    import numpy as np

    from .configs import PFConfig
    from .io import sim
    from .models import particle_filter as pf

    dev = _device(args.device)
    m = sim.simulate(
        sim.MissionSpec(duration_s=args.duration, gps_surface_z=-100.0,
                        gps_std=0.3, dvl_std=0.02, seed=args.seed)
    )
    tl = pf.pf_timeline(m).to(dev)
    cfg = PFConfig(motion_cov=(1e-4, 1e-4, 0, 0, 0, 1e-6))
    params = pf.make_params(cfg, device=dev)

    def run():
        return pf.run(tl, params, cfg, n_particles=args.particles,
                      scheme="systematic" if args.pallas else "residual",
                      use_pallas=args.pallas)[1]["mean"]

    run()                      # warm-up (the reference's compile run)
    t0 = _clock(dev)
    mean = run()
    dt = _clock(dev) - t0
    gt = m.gt_at(tl.ticks.cpu().numpy().astype(np.float64))
    err = np.linalg.norm(mean.cpu().numpy()[:, :2] - gt[:, :2], axis=-1)
    rep = {
        "particles": args.particles,
        "ticks": int(tl.num_ticks),
        "wall_s": round(dt, 3),
        "particle_updates_per_sec": round(args.particles * tl.num_ticks / dt, 1),
        "realtime_factor": round(args.duration / dt, 1),
        "xy_err_mean_m": round(float(err.mean()), 3),
    }
    print(json.dumps(rep, indent=2))
    return rep


def _replay(args):
    """Replay a RECORDED mission log (npz schema, io/logs.py) through the
    EKF-SLAM stack — the rosbag-replay validation workflow of the
    reference (``rosbag_handler.py:7-49``), bags converted via
    ``io.bag_convert``."""
    import numpy as np

    from .configs import EKFSlamConfig
    from .io import logs, observability
    from .models import ekf_slam as slam

    dev = _device(args.device)
    streams, meta = logs.load_log(args.log)
    if "odom" not in streams:
        raise SystemExit(f"log has no 'odom' stream (found {sorted(streams)})")
    cfg = dataclasses.replace(
        EKFSlamConfig(), max_landmarks=args.max_landmarks, max_obs=args.max_obs,
        mhl_dist_mbes=args.mhl_dist, q_mbes_diag=(args.q_mbes,) * 3,
        r_diag=(1e-3,) * 6,
    )
    stats = {}
    tl_np = logs.log_to_timeline(
        streams,
        freq_hz=cfg.system_freq,
        channels=("odom",),
        events={"mbes": cfg.max_obs} if "mbes" in streams else {},
        stats=stats,
    )
    tl = tl_np.to(dev)
    params = slam.make_params(cfg, device=dev)
    t0 = _clock(dev)
    final, out = slam.run(tl, params, cfg)
    wall = _clock(dev) - t0

    os.makedirs(args.out, exist_ok=True)
    ticks = np.asarray(tl_np.ticks, np.float64)
    mu = out["mu"].cpu().numpy()
    extra = {
        "log": args.log,
        "meta": meta,
        "ticks": int(tl.num_ticks),
        "n_landmarks_mapped": int(final.n_active),
        "wall_s": round(wall, 3),
        "realtime_factor": round(float(ticks[-1] - ticks[0]) / wall, 1),
        "event_stats": stats,
    }
    if "gt" in streams:
        base = min(
            s["stamps"][0] for n, s in streams.items() if len(s["stamps"])
        )
        gt_s = streams["gt"]["stamps"] - base
        idx = np.clip(np.searchsorted(gt_s, ticks, side="right") - 1, 0,
                      len(gt_s) - 1)
        gt = np.asarray(streams["gt"]["values"])[idx][:, :6]
        observability.error_dashboard(
            ticks, {"ekf_slam": mu}, gt,
            path=os.path.join(args.out, "dashboard.png"),
        )
        rep = observability.run_report(
            mu, gt, extra=extra, path=os.path.join(args.out, "report.json"), device=dev,
        )
        wrote = _wrote(args.out, ("report.json", "dashboard.png"))
    else:
        rep = dict(extra, final_pose=[round(float(v), 4) for v in mu[-1]])
        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump(rep, f, indent=2)
        wrote = _wrote(args.out, ("report.json",))
    print(json.dumps(rep, indent=2, default=str))
    print(wrote)
    return rep


def main(argv=None):
    p = argparse.ArgumentParser(prog="smarc_navigation_tpu_torch.run")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="simulate + replay DR/odom/SLAM, write report")
    d.add_argument("--duration", type=float, default=60.0)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default="/tmp/smarcnav_demo")
    d.set_defaults(fn=_demo)

    r = sub.add_parser("replay", help="replay a recorded mission log (npz)")
    r.add_argument("--log", required=True, help="npz log (io/logs.py schema)")
    r.add_argument("--out", default="/tmp/smarcnav_replay")
    r.add_argument("--max-landmarks", type=int, default=64)
    r.add_argument("--max-obs", type=int, default=8)
    r.add_argument("--mhl-dist", type=float, default=1.0)
    r.add_argument("--q-mbes", type=float, default=0.1)
    r.set_defaults(fn=_replay)

    f = sub.add_parser("pf", help="particle-filter replay benchmark")
    f.add_argument("--duration", type=float, default=60.0)
    f.add_argument("--particles", type=int, default=1_048_576)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--pallas", action="store_true",
                   help="the kernel path: systematic resampling, K5 and K7")
    f.set_defaults(fn=_pf)

    for sp in (d, r, f):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
