"""Driver ``fleet_replay``: the fleet replay ``models/ekf_slam.run_fleet``
(full covariance, its default ``update_mode``; on the card a cached CUDA
graph per shape), called again and again on a B-mission fleet.

Set-up: the mix's distinct missions from the seed (``traffic/generate``),
tiled to B lanes; N rotations of the fleet on the device (rotation r:
lane b flies mission (b + r) mod N), so that consecutive replays differ;
the port's parameters; one replay to capture the graph and one to replay
it. The window: replay r runs rotation r mod N, back to back with at
most two in flight (the next replay's inputs and graph are submitted while
the one before runs, as a study that queues its batches does), until
``seconds`` have passed; the window closes when the last has finished.
Every replay counts B × T mission steps. Two of the replays, drawn from
the seed as they come (reservoir sampling), keep their outputs for the
check: every lane's per-tick pose, associations and landmark count, and
its final μ, Σ and count. The traced run profiles the window's first two
replays, the second submitted while the first runs.

The check (``judge``) replays every kept lane with the float64 reference
and reports the numbers of ``compare/slam.py``; ``control`` puts the
reference in TF32 in the program's place over the same traffic.
"""

from __future__ import annotations

import time

import numpy as np

from navbench import port
from navbench.compare import slam as compare
from navbench.traffic import generate

KEEP = 2                # replays kept for the check
TRACE_REPLAYS = 2       # replays the traced run profiles: the second overlaps the first
NUMBERS = compare.NUMBERS


class Run:
    pass


def setup(ctx) -> Run:
    import torch
    from smarc_navigation_tpu_torch.models import ekf_slam

    run = Run()
    t0 = time.perf_counter()
    mix = dict(ctx.mix, **ctx.sizes.get("mix", {}))
    gen = generate.make(mix, ctx.config, ctx.seed, ctx.root)
    T = ctx.sizes.get("T")
    tl = gen["distinct"]
    if T:
        tl = _cut(tl, T)
    run.distinct, run.lane_mission = tl, gen["lane_mission"]
    run.cfg = port.slam_config(ctx.config)
    run.N, run.B = len(tl["ticks"]), len(run.lane_mission)
    run.T = tl["ticks"].shape[1]
    lanes = _take(tl, run.lane_mission)
    base = port.timeline(lanes).to(ctx.device)
    run.fleets = [base.map(lambda x, r=r: torch.roll(x, -r, 0).contiguous())
                  for r in range(run.N)]
    run.params = ekf_slam.make_params(run.cfg, device=ctx.device)
    run.replay = lambda r: ekf_slam.run_fleet(run.fleets[r % run.N], run.params, run.cfg)
    t1 = time.perf_counter()
    for r in range(2):            # capture, then one replay of the graph
        run.replay(r)
    port.synchronize(ctx.device)
    run.setup_parts = dict(traffic=t1 - t0, warmup=time.perf_counter() - t1)
    return run


def window(run, ctx, tracer) -> dict:
    rng = np.random.default_rng(ctx.seed % 2**64)
    kept, n, prev = [], 0, None
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        out = run.replay(n)
        done = port.marker(ctx.device)      # passed when this replay has finished
        if len(kept) < KEEP:
            kept.append((n % run.N, out))
        else:
            j = int(rng.integers(0, n + 1))
            if j < KEEP:
                kept[j] = (n % run.N, out)
        n += 1
        if tracer and tracer.active and n >= TRACE_REPLAYS:
            tracer.stop(n * run.T, lambda: port.synchronize(ctx.device))
        if prev is not None:
            prev.synchronize()              # the replay before this one
        prev = done
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    port.synchronize(ctx.device)
    elapsed = time.perf_counter() - t0
    if tracer and tracer.active:     # the window closed first
        tracer.stop(n * run.T, lambda: port.synchronize(ctx.device))
    run.kept = [(r, _host(out)) for r, out in kept]
    return dict(values={"mission_steps_per_s": run.B * run.T * n / elapsed},
                attempted=n * run.B, failed=0, elapsed=elapsed)


def shapes(run, ctx) -> dict:
    """The sizes the per-layer readers count from: B missions, L slots, M
    detections per tick, D = 6 + 3L."""
    L = ctx.config["max_landmarks"]
    return dict(B=run.B, L=L, M=ctx.config["max_obs"], D=6 + 3 * L)


def release(run) -> None:
    """Drop the program's device state before the reference runs."""
    from smarc_navigation_tpu_torch.utils import graphs

    run.fleets = run.params = run.replay = None
    graphs.clear()


def judge(run, ctx) -> list:
    """One set of numbers per kept replay (``compare/slam.numbers``)."""
    from navbench.reference import slam_fleet

    # group the lanes of every kept replay by (mission, decisions): each
    # group is one reference lane, replayed with those decisions
    keys, groups = {}, []
    for r, out in run.kept:
        ids = np.empty(run.B, np.int64)
        for b in range(run.B):
            m = int(run.lane_mission[(b + r) % run.B])
            k = (m, out["matched"][b].tobytes())
            if k not in keys:
                keys[k] = len(groups)
                groups.append((m, out["matched"][b]))
            ids[b] = keys[k]
        out["group"] = ids
    ms = np.array([g[0] for g in groups])
    ev, od = run.distinct["events"]["mbes"], run.distinct["channels"]["odom"]
    ref = slam_fleet.replay(ctx.config, od["value"][ms], od["valid"][ms], ev["value"][ms],
                            ev["mask"][ms], decisions=np.stack([g[1] for g in groups]),
                            device=ctx.device)
    run.notes = compare.notes(ref)
    return [compare.numbers(out, ref, out["group"]) for _, out in run.kept]


def _host(out) -> dict:
    """A replay's outputs as numpy, mission-major."""
    final, o = out
    return dict(pose=o["mu"].transpose(0, 1).cpu().numpy(),
                matched=o["matched_mbes"].transpose(0, 1).cpu().numpy().astype(np.int64),
                n_active_t=o["n_active"].transpose(0, 1).cpu().numpy(),
                mu=final.mu.cpu().numpy(), Sigma=final.Sigma.cpu().numpy(),
                n_active=final.n_active.cpu().numpy())


def _take(tl: dict, idx) -> dict:
    return dict(ticks=tl["ticks"][idx], dt=tl["dt"],
                channels={n: {k: v[idx] for k, v in c.items()} for n, c in tl["channels"].items()},
                events={n: {k: v[idx] for k, v in e.items()} for n, e in tl["events"].items()})


def _cut(tl: dict, T: int) -> dict:
    return dict(ticks=tl["ticks"][:, :T], dt=tl["dt"],
                channels={n: {k: v[:, :T] for k, v in c.items()} for n, c in tl["channels"].items()},
                events={n: {k: v[:, :T] for k, v in e.items()} for n, e in tl["events"].items()})


def control(ctx) -> dict:
    """The control's numbers for ``ctx.seed``: the reference itself in TF32
    in the program's place over the run's distinct missions."""
    return compare.control(ctx.config, *reference_inputs(ctx), device=ctx.device)


def reference_inputs(ctx) -> tuple:
    """The traffic of a run with ``ctx.seed`` as the reference takes it: the
    distinct missions' (odom, valid, z, zmask), each (N, T, ...)."""
    mix = dict(ctx.mix, **ctx.sizes.get("mix", {}))
    tl = generate.make(mix, ctx.config, ctx.seed, ctx.root)["distinct"]
    if ctx.sizes.get("T"):
        tl = _cut(tl, ctx.sizes["T"])
    od, ev = tl["channels"]["odom"], tl["events"]["mbes"]
    return od["value"], od["valid"], ev["value"], ev["mask"]
