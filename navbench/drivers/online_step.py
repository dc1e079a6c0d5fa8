"""Driver ``online_step``: the online single-mission filter
``models/ekf_slam.step`` (``solver="device"``, ``update_mode="auto"``),
one tick at a time, as ``run.py replay`` drives it.

Set-up: the mix's recorded-log missions from the seed (``traffic/
generators/lolo_log``), each turned into a timeline by the port's
``io/logs.log_to_timeline`` and put on the device, sliced per tick; the
port's parameters; the first missions stepped until ``WARMUP_BURSTS``
ticks with detections have run. The window is a closed loop over the missions in turn, each
from a fresh state and its first tick: a tick is timed on the host clock
from handing it to ``step`` until its pose is on the host; the next starts
when it has ended; the window closes after the tick that reaches
``seconds``. Every mission run of the window, the last one cut where the
window closed, is kept for the check. The traced run profiles the
window's first ``TRACE_TICKS`` ticks.

The check (``judge``) replays every kept mission run with the float64
reference and reports the numbers of ``compare/slam.py``; ``control``
puts the reference in TF32 in the program's place over the same traffic.
"""

from __future__ import annotations

import time

import numpy as np

from navbench import port
from navbench.compare import slam as compare
from navbench.traffic import generate

WARMUP_BURSTS = 10      # ticks with detections stepped in set-up
TRACE_TICKS = 150       # ticks the traced run profiles
NUMBERS = compare.NUMBERS


class Run:
    pass


def setup(ctx) -> Run:
    from smarc_navigation_tpu_torch.io import logs
    from smarc_navigation_tpu_torch.models import ekf_slam

    run = Run()
    t0 = time.perf_counter()
    mix = dict(ctx.mix, **ctx.sizes.get("mix", {}))
    run.logs = generate.make(mix, ctx.config, ctx.seed, ctx.root)
    run.cfg = cfg = port.slam_config(ctx.config)
    T = ctx.sizes.get("T")
    run.ticks, bursts = [], []
    for streams in run.logs:
        tl = logs.log_to_timeline(streams, freq_hz=cfg.system_freq, channels=("odom",),
                                  events={"mbes": cfg.max_obs})
        n = tl.num_ticks if not T else min(T, tl.num_ticks)
        bursts.append(np.asarray(tl.events["mbes"].mask[:n]).any(1))
        tl = tl.to(ctx.device)
        run.ticks.append([tl.slice_tick(k) for k in range(n)])
    run.params = ekf_slam.make_params(cfg, device=ctx.device)
    run.init = lambda: ekf_slam.init_state(cfg, device=ctx.device)
    run.step = lambda st, tick: ekf_slam.step(cfg, run.params, st, tick, solver="device",
                                              update_mode="auto")
    t1 = time.perf_counter()
    # warm-up: the first missions' ticks until WARMUP_BURSTS ticks with
    # detections have run (every first use of the DA path is on such a tick)
    want, seen = WARMUP_BURSTS, 0
    for ticks, burst in zip(run.ticks, bursts):
        st = run.init()
        for tick, b in zip(ticks, burst):
            st, out = run.step(st, tick)
            out["mu"].cpu()
            seen += int(b)
            if seen >= want:
                break
        if seen >= want:
            break
    port.synchronize(ctx.device)
    run.setup_parts = dict(traffic=t1 - t0, warmup=time.perf_counter() - t1)
    return run


def window(run, ctx, tracer) -> dict:
    lat, runs = [], []
    j, k, st = 0, 0, run.init()
    cur = dict(mission=0, pose=[], matched=[], n_active=[])
    done = 0
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        st, out = run.step(st, run.ticks[j][k])
        pose = out["mu"].cpu()
        lat.append(time.perf_counter() - a)
        cur["pose"].append(pose)
        cur["matched"].append(out["matched_mbes"])
        cur["n_active"].append(out["n_active"])
        k += 1
        done += 1
        if tracer and tracer.active and done >= TRACE_TICKS:
            tracer.stop(done, lambda: port.synchronize(ctx.device))
        over = time.perf_counter() - t0 >= ctx.seconds
        if k == len(run.ticks[j]) or over:
            cur["final"] = st
            runs.append(cur)
            if over:
                break
            j, k, st = (j + 1) % len(run.ticks), 0, run.init()
            cur = dict(mission=j, pose=[], matched=[], n_active=[])
    elapsed = time.perf_counter() - t0
    if tracer and tracer.active:     # the window closed first
        tracer.stop(done, lambda: port.synchronize(ctx.device))
    run.kept = [_host(r) for r in runs]
    lat_ms = np.asarray(lat) * 1e3
    return dict(values={"mission_steps_per_s": done / elapsed,
                        "tick_p95_ms": float(np.percentile(lat_ms, 95))},
                attempted=done, failed=0, elapsed=elapsed)


def shapes(run, ctx) -> dict:
    """The sizes the per-layer readers count from: one mission, L slots, M
    detections per tick, D = 6 + 3L."""
    L = ctx.config["max_landmarks"]
    return dict(B=1, L=L, M=ctx.config["max_obs"], D=6 + 3 * L)


def release(run) -> None:
    run.ticks = run.params = run.step = run.init = None


def judge(run, ctx) -> list:
    """One set of numbers over every mission run of the window."""
    from navbench import check
    from navbench.reference import slam_fleet

    cfg = ctx.config
    tls = _timelines(cfg, run.logs)
    Tmax = max(len(r["pose"]) for r in run.kept)
    M = cfg["max_obs"]
    N = len(run.kept)
    odom = np.zeros((N, Tmax, 13))
    valid = np.zeros((N, Tmax), bool)
    z = np.zeros((N, Tmax, M, 3))
    zmask = np.zeros((N, Tmax, M), bool)
    dec = np.full((N, Tmax, M), -1, np.int64)
    for i, r in enumerate(run.kept):
        n, tl = len(r["pose"]), tls[r["mission"]]
        od, ev = tl["channels"]["odom"], tl["events"]["mbes"]
        odom[i, :n], valid[i, :n] = od["value"][:n], od["valid"][:n]
        z[i, :n], zmask[i, :n], dec[i, :n] = ev["value"][:n], ev["mask"][:n], r["matched"]
    # past a run's end its lane has no odometry: the state stays as it ended
    ref = slam_fleet.replay(cfg, odom, valid, z, zmask, decisions=dec, device=ctx.device)
    run.notes = compare.notes(ref)
    out = []
    for i, r in enumerate(run.kept):
        n = len(r["pose"])
        p = dict(pose=r["pose"][None], n_active_t=r["n_active"][None], mu=r["mu"][None],
                 Sigma=r["Sigma"][None], n_active=r["n_active"][-1:])
        q = dict(pose=ref["pose"][i:i + 1, :n], n_active_t=ref["n_active_t"][i:i + 1, :n],
                 mu=ref["mu"][i:i + 1],
                 Sigma=ref["Sigma"][i:i + 1], n_active=ref["n_active"][i:i + 1])
        out.append(compare.numbers(p, q))
    return [check.worst(out)]


def _host(r: dict) -> dict:
    import torch

    st = r["final"]
    return dict(mission=r["mission"], pose=torch.stack(r["pose"]).double().numpy(),
                matched=torch.stack(r["matched"]).cpu().numpy().astype(np.int64),
                n_active=torch.stack(r["n_active"]).cpu().numpy().astype(np.int64),
                mu=st.mu.cpu().numpy(), Sigma=st.Sigma.cpu().numpy())


def _timelines(cfg: dict, logs: list) -> list:
    return [generate.log_to_timeline(s, cfg["system_freq"], ("odom",), {"mbes": cfg["max_obs"]})
            for s in logs]


def control(ctx) -> dict:
    """The control's numbers for ``ctx.seed``: the reference itself in TF32
    in the program's place over the run's missions."""
    return compare.control(ctx.config, *reference_inputs(ctx), device=ctx.device)


def reference_inputs(ctx) -> tuple:
    """The traffic of a run with ``ctx.seed`` as the reference takes it:
    each mission's (odom, valid, z, zmask), padded to the longest with
    ticks that have no odometry."""
    mix = dict(ctx.mix, **ctx.sizes.get("mix", {}))
    tls = _timelines(ctx.config, generate.make(mix, ctx.config, ctx.seed, ctx.root))
    T = max(len(t["ticks"]) for t in tls)
    if ctx.sizes.get("T"):
        T = min(T, ctx.sizes["T"])
    out = []
    for key, leaf in (("odom", "value"), ("odom", "valid"), ("mbes", "value"), ("mbes", "mask")):
        arrs = [(t["channels"] if key == "odom" else t["events"])[key][leaf][:T] for t in tls]
        pad = np.zeros((len(arrs), T) + arrs[0].shape[1:], arrs[0].dtype)
        for i, a in enumerate(arrs):
            pad[i, :len(a)] = a
        out.append(pad)
    return tuple(out)
