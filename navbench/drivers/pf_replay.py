"""Driver ``pf_replay``: the GPS-weighted particle filter
``models/particle_filter.run`` on the kernel path (``scheme="systematic"``,
``use_pallas=True``: ``run_fast_segmented``, as ``run.py pf --pallas``),
one mission replayed after another.

Set-up: the mix's distinct missions from the seed (``traffic/generators/
pf_mission``), each a timeline on the device; the port's parameters from
the configuration; one mission replayed to warm every shape. The window:
replay r runs mission r mod N from a ``torch.Generator`` of its own, seeded
from the run's seed and r, back to back with one in flight (each replay's
first act reads its update flags to the host, which waits for the replay
before it), as an operator reprocessing recorded surface tracks runs them,
until ``seconds`` have passed; the window closes when the last has
finished. Every replay counts T mission steps. Two of the replays, drawn
from the seed as they come (reservoir sampling), keep their outputs for the
check: the per-tick mean and covariance and the final bank. The traced run
profiles the window's first two replays.

The check (``judge``), after the window with the program's state freed,
replays each kept one again from its generator with the port's
``systematic_counts`` observed (``counted``: the same calls, each result
recorded), for the resamples it made and their counts; the float64
reference replays it from the same generator, breaking near ties of each
resample as those counts did, and ``compare/pf.py`` reads the kept
outputs against it. The path is deterministic (order-pinned sums, a
counter-based generator), so the second replay resamples as the kept one
did; one that did not would leave lineages of its own, which the numbers
see. ``control`` holds the reference's bank and weights in float16 in the
program's place over the first replay's mission and generator.
"""

from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np

from navbench import port
from navbench.compare import pf as compare
from navbench.drivers.fleet_replay import _cut
from navbench.drivers.fleet_replay import _take as _mission
from navbench.traffic import generate

KEEP = 2                # replays kept for the check
TRACE_REPLAYS = 2       # replays the traced run profiles
NUMBERS = compare.NUMBERS


class Run:
    pass


def replay_seed(seed: int, r: int) -> int:
    """The generator seed of replay r of a run with ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, r]).generate_state(1, np.uint64)[0] >> 1)


def _pf_config(fields: dict, n: int):
    from smarc_navigation_tpu_torch.configs import PFConfig

    names = {f.name for f in dataclasses.fields(PFConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in fields.items() if k in names}
    return PFConfig(**dict(kw, particle_count=n))


def _generator(seed: int, r: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(replay_seed(seed, r))


def _distinct(ctx) -> dict:
    mix = dict(ctx.mix, **ctx.sizes.get("mix", {}))
    tl = generate.make(mix, ctx.config, ctx.seed, ctx.root)["distinct"]
    return _cut(tl, ctx.sizes["T"]) if ctx.sizes.get("T") else tl


def _particles(ctx) -> int:
    return int(ctx.sizes.get("particles", ctx.config["particle_count"]))


def segments(upd: np.ndarray, k_max: int) -> list:
    """The ticks of each K5 call of a mission with update flags ``upd``:
    runs of at most ``k_max`` ticks, each ending at an update tick or at
    the cap, the last at the mission's end."""
    out, start = [], 0
    for t, u in enumerate(upd):
        if u or t - start + 1 == k_max:
            out.append(t - start + 1)
            start = t + 1
    if start < len(upd):
        out.append(len(upd) - start)
    return out


def setup(ctx) -> Run:
    import torch
    from smarc_navigation_tpu_torch.models import particle_filter as pf

    # the configuration's segment cap is the port's own (no option sets it)
    k_max = inspect.signature(pf.run_fast_segmented).parameters["k_max"].default
    if ctx.config["k_max"] != k_max:
        raise ValueError(f"the configuration's k_max {ctx.config['k_max']} is not the port's {k_max}")
    run = Run()
    t0 = time.perf_counter()
    run.distinct = _distinct(ctx)
    run.N, run.T = run.distinct["ticks"].shape
    run.n = _particles(ctx)
    run.cfg = _pf_config(ctx.config, run.n)
    run.timelines = [port.timeline(_mission(run.distinct, i)).to(ctx.device)
                     for i in range(run.N)]
    run.params = pf.make_params(run.cfg, device=ctx.device)

    def replay(r):
        g = _generator(ctx.seed, r, ctx.device)
        return pf.run(run.timelines[r % run.N], run.params, run.cfg, generator=g,
                      scheme="systematic", use_pallas=True)
    run.replay = replay
    t1 = time.perf_counter()
    replay(0)                       # warm-up: every shape the window uses
    port.synchronize(ctx.device)
    run.setup_parts = dict(traffic=t1 - t0, warmup=time.perf_counter() - t1)
    return run


def window(run, ctx, tracer) -> dict:
    rng = np.random.default_rng(ctx.seed % 2**64)
    kept, n = [], 0
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        fin, out = run.replay(n)
        item = (n, fin.particles, out)
        if len(kept) < KEEP:
            kept.append(item)
        else:
            j = int(rng.integers(0, n + 1))
            if j < KEEP:
                kept[j] = item
        n += 1
        if tracer and tracer.active and n >= TRACE_REPLAYS:
            tracer.stop(n * run.T, lambda: port.synchronize(ctx.device))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    port.synchronize(ctx.device)
    elapsed = time.perf_counter() - t0
    if tracer and tracer.active:     # the window closed first
        tracer.stop(n * run.T, lambda: port.synchronize(ctx.device))
    run.kept = [(r, dict(mean=o["mean"].cpu().numpy(), cov=o["cov"].cpu().numpy(),
                         bank=b.cpu().numpy()))
                for r, b, o in kept]
    return dict(values={"mission_steps_per_s": run.T * n / elapsed},
                attempted=n, failed=0, elapsed=elapsed)


def shapes(run, ctx) -> dict:
    """The sizes the per-layer readers count from: N particles, T ticks a
    replay, and over the traced replays (the window's first) the ticks of
    each K5 call (``seg_ticks``), S calls and U GPS updates a replay."""
    upd = [np.asarray(run.distinct["channels"]["gps"]["fresh"][r % run.N], bool)
           & (np.asarray(run.distinct["channels"]["diving"]["value"][r % run.N])[:, 0] < 0.5)
           for r in range(TRACE_REPLAYS)]
    seg = [k for u in upd for k in segments(u, ctx.config["k_max"])]
    return dict(N=run.n, T=run.T, K=ctx.config["k_max"], seg_ticks=seg,
                S=len(seg) / TRACE_REPLAYS, U=sum(int(u.sum()) for u in upd) / TRACE_REPLAYS)


def counted(replay):
    """``replay()`` with the port's ``resampling.systematic_counts``
    observed -> (its result, the cumulative counts of each resample in call
    order). The calls are the same; each result is recorded as it is
    returned."""
    from smarc_navigation_tpu_torch.ops import resampling

    real, seen = resampling.systematic_counts, []

    def observed(w, u):
        m = real(w, u)
        seen.append(m.clone())
        return m
    resampling.systematic_counts = observed
    try:
        return replay(), seen
    finally:
        resampling.systematic_counts = real


def release(run) -> None:
    """Drop the program's device state before the reference runs."""
    run.timelines = run.params = run.replay = None


def judge(run, ctx) -> list:
    """One set of numbers per kept replay (``compare/pf.numbers``)."""
    from smarc_navigation_tpu_torch.models import particle_filter as pf

    from navbench.reference import pf_mission

    params = pf.make_params(run.cfg, device=ctx.device)
    res, taken, refused, gap = [], [], 0, 0.0
    for r, prog in run.kept:
        mission = _mission(run.distinct, r % run.N)
        tl = port.timeline(mission).to(ctx.device)
        _, counts = counted(lambda: pf.run(tl, params, run.cfg,
                                           generator=_generator(ctx.seed, r, ctx.device),
                                           scheme="systematic", use_pallas=True))
        ref = pf_mission.replay(mission, ctx.config, run.n, _generator(ctx.seed, r, ctx.device),
                                ctx.device, counts=counts)
        res.append(compare.numbers(dict(prog, resamples=len(counts)), ref))
        del tl, counts
        taken.append(ref["ties"]["taken"])
        refused += ref["ties"]["refused"]
        gap = max(gap, ref["ties"]["gap"])
    run.notes = dict(kept=[r for r, _ in run.kept], ties_taken_share=max(taken),
                     ties_refused=refused, tie_gap_max=gap)
    return res


def control(ctx) -> dict:
    """The control's numbers for ``ctx.seed``: the reference with its bank
    and weights held in float16 in the program's place, over the window's
    first replay (mission 0 and its generator)."""
    return compare.control(_mission(_distinct(ctx), 0), ctx.config, _particles(ctx),
                           lambda: _generator(ctx.seed, 0, ctx.device), ctx.device)
