#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one GPU: the EKF-SLAM
fleet replay at the headline shape (L=64) and at the reference-tuned L=256
shape in both covariance semantics, the 2^20-particle PF replay, the
combined PF + SLAM mission, the EKF-localization fleet and the 15-state
dual-EKF fleet.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. a CUDA device must be present; print the card's name and power limit;
  2. build the kernels from ``smarc_navigation_tpu_torch/csrc`` with nvcc,
     one process per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     headline shapes (B=128 missions, L=64 landmark slots, M=8 detections,
     D=198), on the state of the real headline fleet after 50 ticks: K1
     ``da_lanes`` in MBES form (with predict and band) and in FLS form, K2
     ``sequential_update_fleet`` (with a8, band, cand) and K3
     ``sequential_update``, each on its default streamed schedule (phase 1
     + K12 ``symmetric_downdate``) and bitwise equal to the one-kernel
     schedule (Σ, μ, band), timed beside it; K12 on phase 1's factors, timed
     beside ``torch.baddbmm`` and beside its memory path alone (K12 at one
     factor row, ``Tensor.clone`` of Σ); discrete outputs exact, floats
     within 1e-4 of each output's scale;
 3b. the slice-3 kernels against their plain versions at L=256, B=32
     (D=774), on the states of the reference-tuned fleet after 50 ticks in
     each covariance semantics: K1 in its pose-rows form (MBES with predict
     and band, FLS), K4 ``sequential_update_marginal_fleet`` (dim 3 and 2,
     with and without a8), K11 ``hungarian_lanes`` on the DA stage's own
     (B, L+M, M) cost tables, K2 at D=774 (streamed schedule bitwise equal
     to the one-kernel one: Σ, μ, band; Σ exactly symmetric) and K12
     ``symmetric_downdate`` on K2's phase-1 factors, timed beside
     ``torch.baddbmm`` computing Σ − ½(UᵀV + VᵀU) (the yardstick; the port
     never calls it);
  4. the slice against its plain version: ``run_fleet`` of 8 missions over
     100 ticks on the card (kernels) and on the CPU (plain versions);
 4b. the same at L=256 for ``run_fleet(update_mode="marginal")`` and the
     full ``run_fleet`` (streamed schedule);
  5. the headline replay (``slam_fleet_timelines(combined_slam_cfg(), 60, 128)``
     through ``run_fleet``), timed with CUDA events; K1, K2 (phase 1) and
     K12 must each have launched once per tick;
  6. one single-mission ``step`` through K3 (phase 1 + K12);
 5b. the L=256 full replay (``slam_fleet_timelines(cfg256, 60, 32)``, T=601):
     K1, K2 (phase 1) and K12 once per tick; then the streamed and the
     one-kernel K2 schedule over the same first ticks, each on its own graph
     key, bitwise equal;
 5c. the L=256 marginal replay on the same timeline: K1 and K4 once per tick;
  7. each PF kernel against its plain version on the card at N = 2^20, on
     the 60 s PF mission's bank and tick 0-11 parameters: the generator's
     uniforms bitwise; K5 ``predict_call_multi`` (nticks < K, rows past
     nticks zero) and K6 ``predict_call`` (and K6 == K5 at K = 1 bitwise);
     K7 ``expand_gather_call`` on healthy, degenerate and zero-run weights
     (ancestors and bank exact; with the jitter within tolerance) and K8
     ``jitter_moments_call`` (and K7 with the jitter == K8 after K7,
     bitwise);
  8. the PF slice against its plain version: ``run_fast_segmented`` and
     ``run_fast`` at N = 2^20 over a 10 s mission with every noise std zero
     but the initial spread, on the card (kernels) and on the CPU (plain
     versions): mean track within PF_MEAN_TOL, ``updated`` exact; then with
     the noise on, the two paths' banks on the card bitwise equal;
  9. the headline PF replay: ``run(..., scheme="systematic",
     use_pallas=True)`` on the 60 s mission at N = 2^20, timed; K5 must have
     launched once per segment and K7 once per GPS update; then the per-tick
     path (``segmented=False``), K6 once per tick;
 10. the combined mission ``run_combined`` on ``combined_workload(cfg, 60)``,
     timed; K1/K2/K12 once per event tick, K5/K7 as in phase 9;
 11. K9 ``fleet_tick`` against its plain version at B=64 and B=512 (N=64 map
     slots, M=8 detections), on the state of the benchmark's localization
     fleet at its first tick from T_WARM on that brings detections, and
     that tick's inputs: matches exact, μ and Σ within tolerance; then the
     same tick with half the missions out of contact, whose μ and Σ must
     come back bitwise unchanged (K9 runs one block per mission and skips
     the rounds of invalid detections);
 12. K10 ``fleet15_tick`` against its plain version at B=64 in the local
     wiring (5 sensors, with GPS) and the global wiring (4 sensors), on the
     state of the 15-state fleet after T_WARM ticks: x and P within
     tolerance, P exactly symmetric (K10 runs one block per mission and
     skips the sensors whose apply flag is off);
 13. the two slices against their plain versions: ``ekf_localization.
     run_fleet`` and ``ekf_15state.run_dual_fleet`` of 8 distinct missions
     over 100 ticks on the card (kernels) and on the CPU (plain versions):
     matches equal, μ, x and map->odom within POSE_TOL;
 14. the localization replays: ``loc_fleet_timelines(EKFLocConfig(), 60,
     64)`` (T=3001 at 50 Hz) and the same fleet tiled to B=512, timed; K9
     exactly once per tick; then each replay once more under torch.profiler:
     K9's mean device µs per launch over the replay and its share of the
     timed replay (µs × launches / replay time);
 15. the 15-state replays: ``ekf15_fleet_timelines(Ekf15Config(frequency=
     50), 120, 64)`` (T=6001) through ``run_fleet`` (K10 once per tick) and
     ``run_dual_fleet`` with ``global_config(50)`` (K10 twice per tick);
     then K10's mean device µs per launch over each and its share, as in 14.
Phases 5, 5b, 5c, 14 and 15 run each replay's tick loop as a cached CUDA
graph (``utils/graphs.py``), its default on the card. Before each of those
seven replays is timed, its eager loop (``graph=False``) runs on the same
inputs; the first graphed call (eager warm-up, capture and instantiate),
three replays and a replay of the cached graph on a second timeline of the
same shape (the missions permuted, or another seed's mission and map) must
each be bitwise the eager loop's result on the same inputs: every output
and the final state. Each prints µs per tick of the first call, the median
replay and the eager call; the timed replay is a cache hit, and the
profiled one after it gives each path kernel's share of it and the card's
busy share (all kernels' device time over the replay time).
Every kernel's ``ms`` is its device time from ``torch.profiler`` (the
CUPTI trace of 30 launches, or 5 for the one-kernel K2 at D=774); K2's and
K3's are their streamed path's, phase 1 + K12, with the one-kernel
schedule's beside them, and K12's line holds its L=64 and L=256 numbers;
the back-to-back wall time per wrapper call is printed beside it, and
``plain_ms`` is the plain version's back-to-back time on the card;
``library_ms`` (K12's only: ``torch.baddbmm``) is the device time of all
the kernels of one library call, from the same profiler. The
kernel launch counts are reset just before each main path (phases 5, 5b,
5c, 9, 9b, 10, 14 and 15) and read just after it (phase 5's after phase 6). K8 has
no caller on the single-device path (its TPU callers are the
particle-sharded update and the TPU's exact-fallback branch) and K11 none
on any path (the reference calls it from tests only; its JV core runs
inside K1), so their counts are 0. ``bound_ms`` is the larger of the bytes
each kernel must move (inputs read once, outputs written once) over
3.35 TB/s and its float operations over 67 TFLOP/s (H100 SXM data sheet),
computed from this run's inputs (K9's only for the valid detections of the
missions whose tick runs, K10's only for the applied sensors). The second-to-last line is a JSON object
with each kernel's launches, error, times and bound; the last line is the
device JSON.
"""

import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np

POSE_TOL = 1e-2   # slice vs plain over 100 ticks (the reference's fleet-vs-dense bound)
KERNEL_RTOL = 1e-4  # float outputs: max |kernel - plain| <= 1e-4 * max(1, max|plain|)
# PF slice vs plain over 101 ticks at 2^20 particles: per-particle libm ulps
# (logf/sincosf vs torch) and a few stratum-boundary ancestor flips move
# the bank mean by far less than a millimetre
PF_MEAN_TOL = 1e-3
PF_N = 1 << 20
L256_B = 32        # the reference's L=256 fleet (bench.py sec_slam256)
T_WARM = 50        # ticks replayed before a kernel phase takes the fleet's state
N_ONE_KERNEL = 20  # ticks of the L=256 replay timed on the one-kernel K2 schedule
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def wall_ms(fn, n):
    """Back-to-back time per call of fn() over n calls (after one warm-up),
    CUDA events around the loop: for a short kernel this is the host's
    launch rate, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def path_ms(fn, n, kernels):
    """{name fragment: mean device ms per launch} of the CUDA kernels of
    ``kernels``, each launched once per call of fn(), over n calls (after
    one warm-up), from one torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for k in kernels:
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            if k in e.key and e.self_device_time_total > 0:
                total_us += e.self_device_time_total
                count += e.count
        if not 1 <= count <= n:   # the trace may drop a record; it never invents one
            raise AssertionError(f"profiler saw {count} launches of {k}, expected {n}")
        out[k] = total_us / count / 1e3
    return out


def call_device_ms(fn, n):
    """Mean device time (ms) of all the work one call of fn() puts on the
    card (every kernel and copy it launches), over n calls (after one
    warm-up), from one torch.profiler trace: a library call's device time,
    on the clock of ``device_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("profiler saw no device time")
    return total_us / n / 1e3


def device_ms(fn, n, kernel):
    """Mean device time (ms) of the CUDA kernel whose name contains
    ``kernel`` over n calls of fn() (after one warm-up), averaged over the
    launches the trace recorded."""
    return path_ms(fn, n, (kernel,))[kernel]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops):
    """(least time in ms, what bounds it) for moving n_bytes and doing
    flops float operations on the card."""
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def k1_flops(B, L, M, dim, predict):
    """Float operations of the DA stage from the kernel's formulas: per slot
    the point (and pixel) model with its Jacobian, S = HΣ9Hᵀ + Q and its
    inverse, the gated costs; per detection the candidate's; the selection.
    The JV's data-dependent steps are not counted."""
    inn = 2 * dim * 81 + 2 * dim * dim * 9 + 30
    model = 72 + (60 if dim == 2 else 0)
    per_slot = model + inn + M * (2 * dim * dim + 2 * dim) + (216 if predict else 0)
    per_cand = 18 + model + inn
    return B * (L * per_slot + M * per_cand + M * dim * 9 * dim * 2 + (864 if predict else 0))


def k2_flops(B, D, M, dim, predict):
    """The sequential update in factor form: the nine rows of each update
    with the earlier factors' corrections, K_jᵀ and V_j, μ, and the
    downdate (each UᵀV entry once; the transpose gives the other half)."""
    K = M * dim
    upd = D * (9 * dim * M * (M - 1) + 36 * dim * M)
    return B * (upd + 2 * K * D * D + 2 * K * D + (72 * D if predict else 0))


def k4_flops(B, D, M, dim, predict):
    """The marginal update: the pose-row predict, then per update Kᵀ and V
    (2·dim·81 FMAs), Σ9' (81·dim) and νᵀKᵀ."""
    return B * ((72 * D if predict else 0) + M * (4 * dim * 81 + 162 * dim + 18 * dim))


PF_TICK_FLOPS = 50  # float ops of one predict tick of one particle (Box-Muller,
                    # the motion integration, the moment sums); the generator's
                    # integer ops are not counted
PF_JITTER_FLOPS = 40  # the resample jitter and moment sums per particle


def k9_flops(have, z_valid, N):
    """Float operations one localization tick needs on these inputs, from
    K9's formulas: the predict (R, ∂R, J, the Σ blocks: ~330 per mission),
    per valid detection and map slot the model, H, W = HΣ, S, its cofactor
    inverse, ν, d, the score and gates (~450), per valid detection the gain
    and the update of μ and Σ (~1,100). An invalid detection changes nothing
    and a mission without contact keeps its input state (its rounds run only
    for the matches of its valid detections), so neither is counted."""
    run = have | z_valid.any(dim=1)
    n_valid = int((z_valid & run[:, None]).sum())
    return int(run.sum()) * 330 + n_valid * (N * 450 + 1100)


def applied_sensors(tick, w):
    """(k, missions applying it) for each sensor of a K10 tick row."""
    out, row = [], 4
    for ix in w.sensor_idx:
        out.append((len(ix), int((tick[:, row + len(ix)] > 0.5).sum())))
        row += len(ix) + 1
    return out


def k10_flops(tick, w):
    """Float operations one 15-state tick needs on these inputs, from K10's
    formulas: the predict (x', A's blocks, AP, Pn: ~2,500 per mission), then
    per applied sensor of k components the k×k Cholesky, 15 triangular
    solves (30k²), x' and the 120 symmetric downdate entries (480k + 360).
    A sensor whose apply flag is off changes nothing and is not counted."""
    return 2500 * tick.shape[0] + sum(n * (k ** 3 + 30 * k * k + 510 * k + 360)
                                      for k, n in applied_sensors(tick, w))


def max_err(got, want, mask=None):
    """(max |got - want|, allowed) with the allowance scaled to want."""
    import torch

    g, w = got.double(), want.double()
    if mask is not None:
        g, w = g[mask], w[mask]
    err = float((g - w).abs().max()) if g.numel() else 0.0
    scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
    assert torch.isfinite(g).all(), "non-finite kernel output"
    return err, KERNEL_RTOL * scale


def compare_da(got, want, z_mask, what):
    """K1 outputs: discrete exact, floats within tolerance where a detection
    is present (a masked FLS detection's model is singular and unused)."""
    worst = 0.0
    for i, name in enumerate(["col_to_row", "H_sel", "SinvH", "nu_sel", "cand",
                              "do", "add", "slot"]):
        if name in ("col_to_row", "do", "add", "slot"):
            if not bool((got[i] == want[i]).all()):
                raise AssertionError(f"{what}: {name} differs from the plain version")
            continue
        err, tol = max_err(got[i], want[i], None if name == "cand" else z_mask)
        if err > tol:
            raise AssertionError(f"{what}: {name} max err {err:.3e} > {tol:.3e}")
        worst = max(worst, err)
    return worst


def band_entries(band):
    return band[:, [a * 8 + d for a in range(3) for d in range(3 - a)], :]


def bank_err(got, want):
    """Max |kernel - plain| over a (6, N) bank, yaw compared modulo 2π (an
    ulp can move a yaw across the ±π seam), and the allowance."""
    import math

    import torch

    err, tol = max_err(got[0:5], want[0:5])
    d = torch.remainder(got[5].double() - want[5].double() + math.pi, 2 * math.pi) - math.pi
    return max(err, float(d.abs().max())), tol


def check(err_tol, what):
    err, tol = err_tol
    if not err <= tol:
        raise AssertionError(f"{what}: max err {err:.3e} > {tol:.3e}")
    return err


def pf_kernels_phase(dev, tl_pf):
    """Phase 7: K5-K8 against their plain versions at N = 2^20."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.ops import pf_kernels as PK
    from smarc_navigation_tpu_torch.ops import resampling as RS

    n = PF_N
    cfg = PFConfig(particle_count=n)
    params = PF.make_params(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    parts = PF.init_state(n, params, gen).particles
    pre = PF._tick_precompute(tl_pf, params, gen)
    par16, seeds = pre.par16[0:12].contiguous(), pre.seeds[0:12].contiguous()
    nxy, nyaw = PF._noise_flags(params)
    res = {}

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    for draw in range(4):
        s = int(seeds[draw])
        if not torch.equal(PK.uniforms_call(s, n, draw, dev), PK.uniforms(seeds[draw], idx, draw)):
            raise AssertionError(f"generator: kernel uniforms differ from torch (draw {draw})")

    # K5: nticks < K, the main path's noise flags and all noise rows on
    par_on = par16.clone()
    par_on[:, 7:9] = 0.05
    errs = []
    for p16, flags in ((par16, (nxy, nyaw)), (par_on, (True, True))):
        out, sums = PK.predict_call_multi(parts, p16, seeds, *flags, nticks=9)
        torch.cuda.synchronize()
        ro, rs = PK.predict_call_multi_reference(parts, p16, seeds, *flags, nticks=9)
        errs.append(check(bank_err(out, ro), f"K5 bank {flags}"))
        errs.append(check(max_err(sums, rs), f"K5 sums {flags}"))
        if not bool((sums[9:] == 0).all()):
            raise AssertionError("K5: sums rows past nticks are not zero")
    nt = 10   # the main path's segment: a GPS fix every 10 ticks

    def k5():
        return PK.predict_call_multi(parts, par16, seeds, nxy, nyaw, nticks=nt)

    res["K5"] = dict(err=max(errs), ms=device_ms(k5, 30, "predict_kernel"), wall_ms=wall_ms(k5, 50),
                     plain_ms=wall_ms(lambda: PK.predict_call_multi_reference(
                         parts, par16, seeds, nxy, nyaw, nticks=nt), 5), nticks=nt,
                     bound=bound(nbytes(parts, par16, seeds, *k5()), n * nt * PF_TICK_FLOPS))

    # K6 == K5 at K = 1, bitwise; against its plain version
    o6, s6 = PK.predict_call(parts, par16[0], seeds[0], nxy, nyaw)
    o5, s5 = PK.predict_call_multi(parts, par16[:1], seeds[:1], nxy, nyaw)
    torch.cuda.synchronize()
    if not (torch.equal(o6, o5) and torch.equal(s6, s5[0])):
        raise AssertionError("K6 differs from K5 at K = 1")
    r6, rs6 = PK.predict_call_reference(parts, par16[0], seeds[0], nxy, nyaw)
    e6 = max(check(bank_err(o6, r6), "K6 bank"), check(max_err(s6, rs6), "K6 sums"))

    def k6():
        return PK.predict_call(parts, par16[0], seeds[0], nxy, nyaw)

    res["K6"] = dict(err=e6, ms=device_ms(k6, 30, "predict_kernel"), wall_ms=wall_ms(k6, 50),
                     plain_ms=wall_ms(lambda: PK.predict_call_reference(
                         parts, par16[0], seeds[0], nxy, nyaw), 10),
                     bound=bound(nbytes(parts, par16[0], seeds[0], *k6()), n * PF_TICK_FLOPS))

    # K7 / K8 on the bank after the predict, for healthy, degenerate and
    # zero-run weights
    bank = o5
    t_up = int(pre.do_update.nonzero()[0])
    gps = pre.gps_xy[t_up]
    logw = -0.5 * ((gps[0] - bank[0]) ** 2 + (gps[1] - bank[1]) ** 2) / params.meas_var
    w_healthy = RS.normalize_weights_det(logw)
    w_deg = torch.zeros(n, device=dev)
    w_deg[777] = 1.0
    w_zr = torch.zeros(n, device=dev)
    w_zr[:64] = 1.0
    w_zr[-64:] = 1.0
    sd = torch.sqrt(params.res_noise_cov)
    jsd = torch.stack([sd[0], sd[1], sd[5]]).contiguous()
    seed = pre.noise_seeds[t_up]
    e7 = e8 = 0.0
    for name, w in (("healthy", w_healthy), ("degenerate", w_deg), ("zero-run", w_zr / 128)):
        m_cum = RS.systematic_counts(w, pre.res_u[t_up])
        got = PK.expand_gather_call(m_cum, bank)
        torch.cuda.synchronize()
        if not torch.equal(got, PK.expand_gather_call_reference(m_cum, bank)):
            raise AssertionError(f"K7 ({name}): gathered bank differs from the plain version")
        fused, s7 = PK.expand_gather_call(m_cum, bank, jsd, seed)
        rf, rs7 = PK.expand_gather_call_reference(m_cum, bank, jsd, seed)
        e7 = max(e7, check(bank_err(fused, rf), f"K7 jitter bank ({name})"),
                 check(max_err(s7, rs7), f"K7 jitter sums ({name})"))
        two, s8 = PK.jitter_moments_call(got, jsd, seed)
        torch.cuda.synchronize()
        if not (torch.equal(fused, two) and torch.equal(s7, s8)):
            raise AssertionError(f"K7 with the jitter differs from K8 after K7 ({name})")
        r8, rs8 = PK.jitter_moments_call_reference(got, jsd, seed)
        e8 = max(e8, check(bank_err(two, r8), f"K8 bank ({name})"),
                 check(max_err(s8, rs8), f"K8 sums ({name})"))
        if name == "healthy":
            m_h, g_h = m_cum, got

    def k7():
        return PK.expand_gather_call(m_h, bank, jsd, seed)

    def k8():
        return PK.jitter_moments_call(g_h, jsd, seed)

    res["K7"] = dict(err=e7, ms=device_ms(k7, 30, "resample_kernel"), wall_ms=wall_ms(k7, 50),
                     plain_ms=wall_ms(lambda: PK.expand_gather_call_reference(
                         m_h, bank, jsd, seed), 10),
                     bound=bound(nbytes(m_h, bank, jsd, *k7()), n * PF_JITTER_FLOPS))
    res["K8"] = dict(err=e8, ms=device_ms(k8, 30, "resample_kernel"), wall_ms=wall_ms(k8, 50),
                     plain_ms=wall_ms(lambda: PK.jitter_moments_call_reference(
                         g_h, jsd, seed), 10),
                     bound=bound(nbytes(g_h, jsd, *k8()), n * PF_JITTER_FLOPS))
    for k, v in res.items():
        print(f"{k}: max err {v['err']:.3e}; kernel {v['ms']:.4f} ms device "
              f"({v['wall_ms']:.4f} ms per call back to back), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]})"
              + (f" (nticks {v['nticks']})" if "nticks" in v else ""), flush=True)
    print("generator: kernel uniforms bitwise equal to torch; K6 == K5(K=1) and "
          "K7(jitter) == K8(K7) bitwise; K7 ancestors exact on healthy, degenerate "
          "and zero-run weights", flush=True)
    return res


def pf_slice_phase(dev, tl10):
    """Phase 8: the PF kernel paths against their plain versions (CPU)."""
    import dataclasses

    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.models import particle_filter as PF

    t0 = time.perf_counter()
    cfg = dataclasses.replace(PFConfig(particle_count=PF_N), motion_cov=(0.0,) * 6,
                              res_noise_cov=(0.0,) * 6)
    worst = 0.0
    for runner in (PF.run_fast_segmented, PF.run_fast):
        outs = []
        for d in (dev, torch.device("cpu")):
            gen = torch.Generator(device=d).manual_seed(5)
            _, out = runner(tl10.to(d), PF.make_params(cfg, device=d), cfg, generator=gen)
            outs.append({k: v.cpu() for k, v in out.items()})
        if not torch.equal(outs[0]["updated"], outs[1]["updated"]):
            raise AssertionError(f"{runner.__name__}: updated differs from the plain version")
        err = float((outs[0]["mean"].double() - outs[1]["mean"].double()).abs().max())
        if not err <= PF_MEAN_TOL:
            raise AssertionError(f"{runner.__name__}: mean track differs by {err:.3e}")
        worst = max(worst, err)
    cfg_on = PFConfig(particle_count=PF_N)
    banks = []
    for runner in (PF.run_fast_segmented, PF.run_fast):
        gen = torch.Generator(device=dev).manual_seed(6)
        fin, _ = runner(tl10.to(dev), PF.make_params(cfg_on, device=dev), cfg_on, generator=gen)
        banks.append(fin.particles)
    if not torch.equal(banks[0], banks[1]):
        raise AssertionError("noise on: run_fast_segmented bank differs from run_fast's")
    print(f"PF slice N={PF_N} T={tl10.num_ticks}: kernels vs plain mean track max err "
          f"{worst:.3e}, updated equal; noise on: segmented bank == per-tick bank bitwise "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def timed(fn):
    """(result, device ms, host s) of fn() between CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    r = fn()
    end.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(end), time.perf_counter() - t0


def bitwise(a, b) -> bool:
    """Bitwise equality of two tensors (NaNs included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def leaves(x) -> list:
    """The tensors of a replay's result (tuples, NamedTuples, dicts), in a
    fixed order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    return [t for v in x for t in leaves(v)]


def assert_bitwise(got, want, what) -> int:
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} outputs, the eager loop {len(w)}")
    for i, (a, b) in enumerate(zip(g, w)):
        if not bitwise(a, b):
            raise AssertionError(f"{what}: output {i} {tuple(a.shape)} differs from the eager loop's")
    return len(g)


def graph_vs_eager(what, run, run2, T):
    """A graphed replay against its eager loop: ``run(graph)`` on the
    replay's inputs, ``run2(graph)`` on a second timeline of the same shape.
    The first graphed call (eager warm-up, capture and instantiate), three
    replays and a replay of the cached graph on the second timeline must
    each be bitwise the eager loop's result on the same inputs. Prints and
    returns µs per tick of the first call, the median replay and the eager
    call (CUDA events around each synchronized call)."""
    import statistics

    from smarc_navigation_tpu_torch.utils import graphs

    eager, eager_ms, _ = timed(lambda: run(False))
    n0 = graphs.captures
    first, first_ms, first_s = timed(lambda: run(True))
    if graphs.captures == n0:
        raise AssertionError(f"{what}: the first graphed call captured no graph")
    n_out = assert_bitwise(first, eager, f"{what} (capture)")
    del first
    steady = []
    for i in range(3):
        r, ms, _ = timed(lambda: run(True))
        assert_bitwise(r, eager, f"{what} (replay {i})")
        steady.append(ms)
    del eager, r
    eager2 = run2(False)
    n1 = graphs.captures
    hit = run2(True)
    if graphs.captures != n1:
        raise AssertionError(f"{what}: the second timeline missed the cached graph")
    assert_bitwise(hit, eager2, f"{what} (second timeline)")
    res = dict(first_us=first_ms * 1e3 / T, steady_us=statistics.median(steady) * 1e3 / T,
               eager_us=eager_ms * 1e3 / T, first_s=first_s)
    print(f"{what} graph: {n_out} outputs bitwise the eager loop's (capture, 3 replays, a second "
          f"timeline through the cached graph); us/tick first call {res['first_us']:.1f} "
          f"({first_s:.2f} s host: eager warm-up + capture + instantiate), steady "
          f"{res['steady_us']:.1f} (median of "
          + ", ".join(f"{m * 1e3 / T:.1f}" for m in steady)
          + f"), eager {res['eager_us']:.1f}", flush=True)
    return res


def device_share(fn, kernels, replay_ms, what):
    """One more call of fn() (a replay) under torch.profiler: each kernel of
    ``kernels`` ({name fragment: launches}) with its mean device µs per
    launch and its share of the timed replay (µs × launches / replay time),
    then the device time of every kernel of the call together, as a share
    of the replay (the card's busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {k: [0.0, 0] for k in kernels}
    busy = 0.0
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            busy += e.self_device_time_total
            for k in kernels:
                if k in e.key:
                    per[k][0] += e.self_device_time_total
                    per[k][1] += e.count
    parts, share = [], 0.0
    for k, launches in kernels.items():
        total, count = per[k]
        if not 1 <= count <= launches:   # the trace may drop a record; it never invents one
            raise AssertionError(f"{what}: profiler saw {count} launches of {k}, expected {launches}")
        us = total / count
        share += us * launches / (replay_ms * 1e3)
        parts.append(f"{k} {us:.3f} us per launch ({count} of {launches} traced)")
    print(f"{what}: " + "; ".join(parts) + f"; x launches = {100 * share:.1f} % of the replay's "
          f"{replay_ms:.1f} ms; all kernels {busy / 1e3:.1f} ms device = "
          f"{100 * busy / (replay_ms * 1e3):.1f} % busy", flush=True)
    return share


def pf_main_paths(dev, cfg, params, counters):
    """Phases 7-10 on the combined workload's missions (``cfg``/``params``
    the SLAM half's); returns (phase-7 kernel results, the PF headline's
    launch counts, the per-tick path's launch counts)."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.io.workloads import combined_workload
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.ops import pf_kernels as PK
    from smarc_navigation_tpu_torch.parallel import fleet as FL

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tls_np, tlp_np = combined_workload(cfg, 60.0)
    tl_pf = tlp_np.to(dev)
    pk = pf_kernels_phase(dev, tl_pf)
    pf_slice_phase(dev, tlp_np.map(lambda x: x[:101]))

    n = PF_N
    pf_cfg = PFConfig(particle_count=n)
    pf_params = PF.make_params(pf_cfg, device=dev)
    T_pf = tl_pf.num_ticks
    upd = (tlp_np.channels["gps"].fresh & (tlp_np.channels["diving"].value[:, 0] < 0.5))
    n_upd = int(upd.sum())
    n_seg = len(PF._segment_plan(upd, 12))
    PF.run(tl_pf.map(lambda x: x[:40]), pf_params, pf_cfg, scheme="systematic",
           use_pallas=True)                                     # warm-up
    pf_counters = [PK.predict_call_multi, PK.predict_call, PK.expand_gather_call,
                   PK.jitter_moments_call]
    for f in pf_counters:
        f.launches = 0
    (fin_pf, out_pf), pf_ms, pf_wall = timed(lambda: PF.run(
        tl_pf, pf_params, pf_cfg, generator=torch.Generator(device=dev).manual_seed(0),
        scheme="systematic", use_pallas=True))
    pf_launch = {f.__name__: f.launches for f in pf_counters}
    if pf_launch["predict_call_multi"] != n_seg or pf_launch["expand_gather_call"] != n_upd:
        raise AssertionError(f"PF headline: launches {pf_launch}, expected K5 {n_seg} "
                             f"(segments) and K7 {n_upd} (GPS updates)")
    for name, x in (("bank", fin_pf.particles), ("mean", out_pf["mean"]), ("cov", out_pf["cov"])):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"PF headline: non-finite {name}")
    gt_end = tlp_np.channels["odom"].value[-1, 0:2]
    xy_err = float(np.linalg.norm(out_pf["mean"][-1, 0:2].cpu().numpy() - gt_end))
    if not xy_err < 1.0:
        raise AssertionError(f"PF headline: final xy error {xy_err:.3f} m against ground truth")
    duration = float(tlp_np.ticks[-1])
    print(f"PF headline N={n} T={T_pf} ({n_seg} segments, {n_upd} GPS updates): "
          f"{pf_ms:.2f} ms on the card ({pf_wall:.3f} s host), {pf_ms * 1e3 / T_pf:.1f} us/tick, "
          f"{n * T_pf / (pf_ms / 1e3):.4g} particle updates/s, real-time factor "
          f"{duration / (pf_ms / 1e3):.1f}x; final xy error vs ground truth {xy_err:.3f} m; "
          f"launches {pf_launch}", flush=True)

    # 9b. the per-tick path (K6 every tick)
    for f in pf_counters:
        f.launches = 0
    (_fin, out_pt), pt_ms, _w = timed(lambda: PF.run(
        tl_pf, pf_params, pf_cfg, generator=torch.Generator(device=dev).manual_seed(0),
        scheme="systematic", use_pallas=True, segmented=False))
    pt_launch = {f.__name__: f.launches for f in pf_counters}
    if pt_launch["predict_call"] != T_pf or pt_launch["expand_gather_call"] != n_upd:
        raise AssertionError(f"PF per-tick path: launches {pt_launch}")
    if not torch.equal(out_pt["mean"], out_pf["mean"]):
        raise AssertionError("PF per-tick path: mean track differs from the segmented path")
    print(f"PF per-tick path: {pt_ms:.2f} ms ({pt_ms * 1e3 / T_pf:.1f} us/tick), mean track "
          f"bitwise the segmented path's; launches {pt_launch}", flush=True)

    # 10. the combined mission
    tl_s = tls_np.to(dev)
    ev_any = tls_np.events["mbes"].mask.any(axis=(0, 2))
    ev_any[-1] = True
    n_ev = int(ev_any.sum())
    for f in counters + pf_counters:
        f.launches = 0
    val, cb_ms, cb_wall = timed(lambda: FL.run_combined(
        tl_s, tl_pf, params, cfg, pf_params, pf_cfg, n,
        generator=torch.Generator(device=dev).manual_seed(0)))
    cb_launch = {f.__name__: f.launches for f in counters + pf_counters}
    if (cb_launch["da_lanes"] != n_ev or cb_launch["sequential_update_fleet"] != n_ev
            or cb_launch["symmetric_downdate"] != n_ev
            or cb_launch["predict_call_multi"] != n_seg
            or cb_launch["expand_gather_call"] != n_upd):
        raise AssertionError(f"combined: launches {cb_launch}, expected K1/K2/K12 {n_ev} "
                             f"(event ticks), K5 {n_seg}, K7 {n_upd}")
    if not bool(torch.isfinite(val)):
        raise AssertionError("combined: non-finite result")
    print(f"combined mission (SLAM B=1 L={cfg.max_landmarks} M={cfg.max_obs}, {n_ev} event ticks of "
          f"{tls_np.ticks.shape[1]}; PF N={n}): {cb_ms:.1f} ms on the card "
          f"({cb_wall:.2f} s host), real-time factor {duration / (cb_ms / 1e3):.1f}x; "
          f"value {float(val):.4f}; launches {cb_launch}", flush=True)

    return pk, pf_launch, pt_launch


def marginal_err(got, want, what):
    """K4 outputs: pose rows and the consumed band entries within tolerance,
    μ too with the attitudes compared modulo 2π."""
    import math

    import torch

    errs = [check(max_err(got[0][:, 0:6], want[0][:, 0:6]), f"{what} P")]
    d = (got[1].double() - want[1].double())
    d[:, 3:6] = torch.remainder(d[:, 3:6] + math.pi, 2 * math.pi) - math.pi
    err, tol = float(d.abs().max()), KERNEL_RTOL * max(1.0, float(want[1].abs().max()))
    errs.append(check((err, tol), f"{what} mu"))
    errs.append(check(max_err(band_entries(got[2]), band_entries(want[2])), f"{what} band"))
    if not bool(torch.isfinite(got[1]).all()):
        raise AssertionError(f"{what}: non-finite mu")
    return max(errs)


def fls_detections(S, st_mu, active, params_f, M, dev):
    """FLS pixel detections of each mission's first M-1 mapped landmarks
    (with pixel noise) plus one far candidate, through a tilted, offset
    sonar mount; masked where the slot is not active."""
    import torch

    B = st_mu.shape[0]
    L = active.shape[1]
    gen = torch.Generator().manual_seed(7)
    lm = st_mu[:, 6:].reshape(B, L, 3)[:, :M - 1]
    zf = torch.func.vmap(torch.func.vmap(
        lambda p, l: S.h_fls(p, l, params_f), in_dims=(None, 0)))(st_mu[:, 0:6], lm)
    zf = zf + torch.randn(zf.shape, generator=gen).to(dev) * 0.5
    far = st_mu[:, 0:3] + torch.tensor([10.0, 2.0, -0.5], device=dev)
    zfar = torch.func.vmap(lambda p, l: S.h_fls(p, l, params_f))(st_mu[:, 0:6], far)
    z = torch.zeros(B, M, 3, device=dev)
    z[:, :M - 1, 0:2] = zf
    z[:, M - 1, 0:2] = zfar
    zm = torch.cat([active[:, :M - 1], torch.ones(B, 1, dtype=torch.bool, device=dev)], 1)
    return z, zm


def fls_params(S, cfg, dev):
    import torch

    from smarc_navigation_tpu_torch.utils.geometry import Transform, rotmat_from_rpy

    tf = Transform(rot=rotmat_from_rpy(torch.tensor([0.0, 0.08, 0.0], device=dev)),
                   trans=torch.tensor([0.4, 0.0, -0.2], device=dev))
    return S.make_params(cfg, tf_base_fls=tf, device=dev)


def k12_phase(Sigma, U, V, P1, act, what):
    """K12 on phase 1's own factors against its plain version (within
    tolerance, exactly symmetric); its device time, back-to-back time per
    call, the plain version's time, the bound, and ``torch.baddbmm``
    computing Σ − ½(UᵀV + VᵀU) (the yardstick; the port never calls it;
    its device time, all its kernels, on K12's profiler clock).
    Beside them, what its memory path alone costs: K12 on the first factor
    row only (the same bytes of Σ, 1/K of the FMAs) and a contiguous copy of
    Σ (``Tensor.clone``: the same bytes of Σ in and out, streamed)."""
    import torch

    from smarc_navigation_tpu_torch.ops import slam_kernels as K2

    s12 = K2.symmetric_downdate(Sigma, U, V, P1, act)
    torch.cuda.synchronize()
    err = check(max_err(s12, K2.symmetric_downdate_reference(Sigma, U, V, P1, act)),
                f"K12 {what}")
    if not torch.equal(s12, s12.transpose(1, 2)):
        raise AssertionError(f"K12 {what}: Sigma not exactly symmetric")

    def k12():
        return K2.symmetric_downdate(Sigma, U, V, P1, act)

    UV, VU = torch.cat([U, V], 1).transpose(1, 2).contiguous(), torch.cat([V, U], 1).contiguous()
    B, D, K = Sigma.shape[0], Sigma.shape[1], U.shape[1]
    U1, V1 = U[:, :1].contiguous(), V[:, :1].contiguous()
    res = dict(err=err, ms=device_ms(k12, 30, "downdate_kernel"), wall_ms=wall_ms(k12, 50),
               plain_ms=wall_ms(lambda: K2.symmetric_downdate_reference(Sigma, U, V, P1, act), 10),
               library_ms=call_device_ms(lambda: torch.baddbmm(Sigma, UV, VU, alpha=-0.5), 30),
               bound=bound(nbytes(Sigma, U, V, P1, act, s12), 2 * K * D * D * B),
               one_row_ms=device_ms(lambda: K2.symmetric_downdate(Sigma, U1, V1, P1, act), 30,
                                    "downdate_kernel"),
               copy_ms=device_ms(lambda: Sigma.clone(), 30, "Memcpy"))
    print(f"K12 {what} B={B} D={D} K={K}: max err {err:.3e}, exactly symmetric; kernel "
          f"{res['ms']:.4f} ms device ({res['wall_ms']:.4f} ms per call back to back), plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), "
          f"torch.baddbmm {res['library_ms']:.4f} ms; memory path: K12 at K=1 "
          f"{res['one_row_ms']:.4f} ms, Sigma.clone() {res['copy_ms']:.4f} ms", flush=True)
    return res


def slam256_kernels_phase(dev, cfg, params, tl):
    """Phase 3b: K1 pose-rows form, K4, K11, K2 at D=774 and K12 against
    their plain versions at L=256, B=32; K2 streamed == one-kernel."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2

    t0 = time.perf_counter()
    B, L, M = tl.ticks.shape[0], cfg.max_landmarks, cfg.max_obs
    D = 6 + 3 * L
    warm = tl.map(lambda x: x[:, :T_WARM])
    odom = tl.channels["odom"]
    pose_t = S._odom_pose(odom.value[:, T_WARM]).contiguous()
    valid_t = odom.valid[:, T_WARM].contiguous()
    ev = tl.events["mbes"]
    z = ev.value[:, T_WARM].contiguous()
    zm = (ev.mask[:, T_WARM] & valid_t[:, None]).contiguous()
    new_cov = torch.tensor(S.MBES.new_lm_cov, device=dev)
    res = {}

    # --- the marginal carry: K1 pose-rows form, K4 -----------------------------
    fm, _ = S.run_fleet(warm, params, cfg, update_mode="marginal")
    rows = torch.zeros(B, 8, D, device=dev)
    rows[:, 0:6] = fm.Sigma[:, 0:6]
    ms = S.MarginalFleetState(mu=fm.mu, rows=rows, band=S.initial_band(fm.Sigma, L).contiguous(),
                              active=fm.active, n_active=fm.n_active,
                              mu_auv_odom=fm.mu_auv_odom)
    ms_p, a8 = S._fleet_predict_marginal(ms, pose_t, valid_t, params, predict_rows=False)
    base = (ms_p.mu[:, 0:6].contiguous(), ms_p.n_active, ms_p.active,
            ms_p.mu[:, 6:].reshape(B, L, 3).contiguous(), None)
    da_args = base + (z, zm, torch.diagonal(params.Q_mbes), params.lambda_mbes,
                      cfg.outlier_cost, cfg.mhl_dist_mbes, new_cov)
    da_kw = dict(sensor="mbes", A=a8[:, 0:6, 0:6].contiguous(),
                 r_full=a8[:, 0:6, 8:14].contiguous(), band=ms_p.band, pose_rows=ms_p.rows)
    got = K1.da_lanes(*da_args, **da_kw)
    torch.cuda.synchronize()
    want = K1.da_lanes_reference(*da_args, **da_kw)
    e1 = compare_da(got, want, zm, "K1 pose rows MBES")
    params_f = fls_params(S, cfg, dev)
    zf, zfm = fls_detections(S, ms_p.mu, ms_p.active, params_f, M, dev)
    zfm = zfm & valid_t[:, None]
    fls_args = base + (zf, zfm, torch.diagonal(params_f.Q_fls), params_f.lambda_fls,
                       cfg.outlier_cost, cfg.mhl_dist_fls, torch.tensor(S.FLS.new_lm_cov, device=dev))
    fls_kw = dict(sensor="fls", r_sb=params_f.r_fls_base, t_sb=params_f.t_fls_base,
                  band=ms_p.band, pose_rows=ms_p.rows)
    gotf = K1.da_lanes(*fls_args, **fls_kw)
    torch.cuda.synchronize()
    e1f = compare_da(gotf, K1.da_lanes_reference(*fls_args, **fls_kw), zfm, "K1 pose rows FLS")
    res["K1_pose_rows"] = dict(err=max(e1, e1f), ms=device_ms(
        lambda: K1.da_lanes(*da_args, **da_kw), 30, "da_kernel"))
    print(f"K1 da_lanes pose-rows form L={L} B={B}: MBES detections {int(zm.sum())}, "
          f"do {int(got[5].sum())}, add {int(got[6].sum())}; FLS detections {int(zfm.sum())}, "
          f"do {int(gotf[5].sum())}; max err {res['K1_pose_rows']['err']:.3e}; kernel "
          f"{res['K1_pose_rows']['ms']:.4f} ms device", flush=True)

    errs4 = []
    k4_main = None
    for sel, nc, what in ((got, new_cov, "MBES"), (gotf, fls_args[11], "FLS")):
        ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = sel
        for a8x in (a8, None):
            args4 = (ms_p.rows, ms_p.mu, H_sel, SinvH, nu_sel, (6 + 3 * slot).contiguous(), do,
                     add, nc, cand, ms_p.band, a8x)
            g4 = K2.sequential_update_marginal_fleet(*args4)
            torch.cuda.synchronize()
            w4 = K2.sequential_update_marginal_fleet_reference(*args4)
            errs4.append(marginal_err(g4, w4, f"K4 {what} a8={a8x is not None}"))
            if k4_main is None:
                k4_main = (args4, g4)
    args4, g4 = k4_main

    def k4():
        return K2.sequential_update_marginal_fleet(*args4)

    res["K4"] = dict(err=max(errs4), ms=device_ms(k4, 30, "marginal_kernel"),
                     wall_ms=wall_ms(k4, 50), plain_ms=wall_ms(
                         lambda: K2.sequential_update_marginal_fleet_reference(*args4), 5),
                     bound=bound(nbytes(*args4[:-1], args4[-1], *g4),
                                 k4_flops(B, D, M, 3, True)))

    # --- K11 on the DA stage's own cost tables ----------------------------------
    cost = K1.da_tables_reference(*da_args, **da_kw)[0].contiguous()
    ctr11 = K1.hungarian_lanes(cost)
    torch.cuda.synchronize()
    if not (torch.equal(ctr11, K1.hungarian_lanes_reference(cost)) and torch.equal(ctr11, want[0])):
        raise AssertionError("K11: col_to_row differs from the plain version")
    R, C = cost.shape[1], cost.shape[2]

    def k11():
        return K1.hungarian_lanes(cost)

    res["K11"] = dict(err=0.0, ms=device_ms(k11, 30, "jv_kernel"), wall_ms=wall_ms(k11, 50),
                      plain_ms=wall_ms(lambda: K1.hungarian_lanes_reference(cost), 3),
                      bound=bound(nbytes(cost, ctr11), 4 * B * C * R), shape=(B, R, C))

    # --- the full carry: K2 at D=774, phase 1 + K12 ---------------------------
    st, _ = S.run_fleet(warm, params, cfg)
    band = S.initial_band(st.Sigma, L).contiguous()
    st_p, a8f = S._fleet_predict(st, pose_t, valid_t, params)
    da_full = (st_p.mu[:, 0:6].contiguous(), st_p.n_active, st_p.active,
               st_p.mu[:, 6:].reshape(B, L, 3).contiguous(), st_p.Sigma, z, zm,
               torch.diagonal(params.Q_mbes), params.lambda_mbes, cfg.outlier_cost,
               cfg.mhl_dist_mbes, new_cov)
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = K1.da_lanes(
        *da_full, sensor="mbes", A=a8f[:, 0:6, 0:6].contiguous(),
        r_full=a8f[:, 0:6, 8:14].contiguous(), band=band)
    k2_args = (st_p.Sigma, st_p.mu, H_sel, SinvH, nu_sel, (6 + 3 * slot).contiguous(), do, add,
               new_cov, cand, a8f, band)
    one = K2.sequential_update_fleet(*k2_args, streamed=False)
    strm = K2.sequential_update_fleet(*k2_args, streamed=True)
    torch.cuda.synchronize()
    for g, o, name in zip(strm, one, ("Sigma", "mu", "band")):
        if not bitwise(g, o):
            raise AssertionError(f"K2 at D={D}: streamed {name} differs from the one-kernel schedule's")
    if not torch.equal(strm[0], strm[0].transpose(1, 2)):
        raise AssertionError(f"K2 at D={D}: Sigma not exactly symmetric")
    want2 = K2.sequential_update_fleet_reference(*k2_args, streamed=False)
    e2 = max(check(max_err(strm[0], want2[0]), "K2 D=774 Sigma"),
             check(max_err(strm[1], want2[1]), "K2 D=774 mu"),
             check(max_err(band_entries(strm[2]), band_entries(want2[2])), "K2 D=774 band"))
    _, _, P1, U, V, act = K2.phase1(*k2_args)
    res["K12"] = k12_phase(st_p.Sigma, U, V, P1, act, f"L={L}")
    res["K2_774"] = dict(err=e2, ms=device_ms(lambda: K2.sequential_update_fleet(
        *k2_args, streamed=False), 5, "update_kernel"),
        phase1_ms=device_ms(lambda: K2.phase1(*k2_args), 30, "phase1_kernel"),
        bound=bound(nbytes(*k2_args, *one), k2_flops(B, D, M, 3, True)))
    for k in ("K4", "K11"):
        v = res[k]
        print(f"{k}: max err {v['err']:.3e}; kernel {v['ms']:.4f} ms device ({v['wall_ms']:.4f} ms "
              f"per call back to back), plain {v['plain_ms']:.4f} ms, bound {v['bound'][0]:.4f} ms "
              f"({v['bound'][1]})", flush=True)
    v = res["K2_774"]
    print(f"K2 at D={D} B={B}: streamed schedule phase 1 {v['phase1_ms']:.4f} ms + K12 "
          f"{res['K12']['ms']:.4f} ms = {v['phase1_ms'] + res['K12']['ms']:.4f} ms device; "
          f"one-kernel schedule {v['ms']:.4f} ms (max err vs plain {v['err']:.3e}, bound "
          f"{v['bound'][0]:.4f} ms, {v['bound'][1]}); streamed == one-kernel: Sigma, mu and band "
          f"bitwise, Sigma exactly symmetric ({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def slam256_slice_phase(dev, cfg, params, tl8_np):
    """Phase 4b: the L=256 marginal and full fleets, kernels vs plain."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_slam as S

    for mode in ("marginal", "full"):
        t0 = time.perf_counter()
        fin_k, out_k = S.run_fleet(tl8_np.to(dev), params, cfg, update_mode=mode)
        fin_p, out_p = S.run_fleet(tl8_np.to("cpu"), S.make_params(cfg, device="cpu"), cfg,
                                   update_mode=mode)
        for key in ("matched_mbes", "n_active"):
            if not torch.equal(out_k[key].cpu(), out_p[key]):
                raise AssertionError(f"L=256 {mode} slice: {key} differs between kernels and plain")
        pose_err = float((out_k["mu"].cpu() - out_p["mu"]).abs().max())
        if not pose_err <= POSE_TOL:
            raise AssertionError(f"L=256 {mode} slice: pose differs by {pose_err:.3e} > {POSE_TOL}")
        print(f"L=256 {mode} slice B={out_k['mu'].shape[1]} T={out_k['mu'].shape[0]}: "
              f"matched_mbes and n_active equal ({int((out_k['matched_mbes'] >= 0).sum())} matches, "
              f"n_active {out_k['n_active'][-1].tolist()}), max pose err {pose_err:.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def slam256_replays(dev, cfg, params, tl, counters):
    """Phases 5b-5c: the L=256 replays in both semantics, graphed against
    eager; returns their launch counts and graph timings."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2

    B, T = tl.ticks.shape
    S.run_fleet(tl.map(lambda x: x[:, :10]), params, cfg)                        # warm-up
    S.run_fleet(tl.map(lambda x: x[:, :10]), params, cfg, update_mode="marginal")
    perm = torch.roll(torch.arange(B, device=dev), 1)    # the missions permuted
    tl2 = tl.map(lambda x: x[perm])
    launches, graph = {}, {}
    for mode in ("full", "marginal"):
        graph[mode] = graph_vs_eager(
            f"L=256 {mode} replay", lambda g: S.run_fleet(tl, params, cfg, update_mode=mode, graph=g),
            lambda g: S.run_fleet(tl2, params, cfg, update_mode=mode, graph=g), T)
        for f in counters:
            f.launches = 0
        (final, out), ms, wall = timed(lambda: S.run_fleet(tl, params, cfg, update_mode=mode))
        n = {f.__name__: f.launches for f in counters}
        want = (dict(da_lanes=T, sequential_update_fleet=T, symmetric_downdate=T) if mode == "full"
                else dict(da_lanes=T, sequential_update_marginal_fleet=T))
        if any(n[k] != v for k, v in want.items()):
            raise AssertionError(f"L=256 {mode} replay: launches {n}, expected {want}")
        for name, x in (("mu", final.mu), ("Sigma", final.Sigma), ("out mu", out["mu"])):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"L=256 {mode} replay: non-finite {name}")
        n_act = final.n_active.cpu()
        if not int((n_act > 0).sum()) == B:
            raise AssertionError(f"L=256 {mode} replay: a mission mapped nothing: {n_act}")
        launches[mode] = n
        print(f"L=256 {mode} replay B={B} T={T} (graphed): {ms:.1f} ms on the card ({wall:.2f} s "
              f"host), {ms * 1e3 / T:.1f} us/fleet tick, {B * T / (ms / 1e3):.0f} steps/s; n_active "
              f"min {int(n_act.min())} mean {float(n_act.float().mean()):.1f} max "
              f"{int(n_act.max())}; launches {n}", flush=True)
        kernels = ({"da_kernel": T, "phase1_kernel": T, "downdate_kernel": T} if mode == "full"
                   else {"da_kernel": T, "marginal_kernel": T})
        graph[mode]["share"] = device_share(
            lambda: S.run_fleet(tl, params, cfg, update_mode=mode), kernels, ms,
            f"L=256 {mode} replay (graphed)")

    # the two K2 schedules of the full replay over the same first ticks, each
    # the first call of its own graph key (eager warm-up + capture): the key
    # carries the schedule, so the one-kernel call captures anew and runs no K12
    from smarc_navigation_tpu_torch.utils import graphs

    head = tl.map(lambda x: x[:, :N_ONE_KERNEL])
    runs = {}
    for name, streamed in (("streamed", True), ("one-kernel", False)):
        n_cap, K2.symmetric_downdate.launches = graphs.captures, 0
        runs[name] = timed(lambda: S.run_fleet(head, params, cfg, streamed=streamed))
        want_k12 = N_ONE_KERNEL if name == "streamed" else 0
        if graphs.captures != n_cap + 1 or K2.symmetric_downdate.launches != want_k12:
            raise AssertionError(f"L=256 {name} schedule: {graphs.captures - n_cap} captures, "
                                 f"{K2.symmetric_downdate.launches} K12 launches")
    n_out = assert_bitwise(runs["streamed"][0], runs["one-kernel"][0],
                           "L=256 full replay, streamed vs one-kernel schedule")
    print(f"L=256 full replay, first {N_ONE_KERNEL} ticks (first call: eager + capture): streamed "
          f"schedule {runs['streamed'][1] * 1e3 / N_ONE_KERNEL:.1f} us/tick, one-kernel schedule "
          f"{runs['one-kernel'][1] * 1e3 / N_ONE_KERNEL:.1f} us/tick; all {n_out} outputs bitwise "
          f"equal; one capture each", flush=True)
    return launches, graph


LOC_SPEC = dict(num_landmarks=16, dvl_std=0.05, mbes_std=0.05, landmark_area_m=20.0,
                mbes_range_m=30.0)   # phase 13: a dense field, so most detections associate


def loc_tick_args(tl, params, cfg, t):
    """K9's arguments at tick t of a fleet, from the replay's own staging."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_localization as LOC

    tick_t, z_t, _map4, _par, _lf = LOC.stage_fleet(tl, params, cfg)
    tk, zz = tick_t[t], z_t[t]
    return [tk[:, 0:3].contiguous(), tk[:, 3:6].contiguous(), tk[:, 6] > 0.5,
            zz[..., 0:3].contiguous(), zz[..., 3] > 0.5, params.map_pos, params.map_mask,
            torch.diagonal(params.Q).contiguous(), torch.diagonal(params.R).contiguous(),
            params.lambda_m, cfg.epsilon]


def loc_kernel_phase(dev, cfg, params, tl64):
    """Phase 11: K9 against its plain version at B=64 and B=512."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_localization as LOC
    from smarc_navigation_tpu_torch.ops import loc_kernels as K9

    # the first tick from T_WARM on that brings detections (the MBES bursts
    # start 12.4 s into the mission), on the state the replay reaches there
    det_any = tl64.events["mbes_detections"].mask.any(dim=2).any(dim=0)
    t_k = T_WARM + int(det_any[T_WARM:].nonzero()[0])
    fin, _ = LOC.run_fleet(tl64.map(lambda x: x[:, :t_k]), params, cfg)
    args64 = [fin.mu.contiguous(), fin.Sigma.contiguous()] + loc_tick_args(tl64, params, cfg, t_k)
    res = {}
    for B in (64, 512):
        reps = B // 64
        args = [a.repeat((reps,) + (1,) * (a.dim() - 1)).contiguous() if i < 7 else a
                for i, a in enumerate(args64)]
        got = K9.fleet_tick(*args)
        torch.cuda.synchronize()
        want = K9.fleet_tick_reference(*args)
        if not torch.equal(got[2], want[2]):
            bad = (got[2] != want[2]).nonzero()[:5].tolist()
            raise AssertionError(f"K9 B={B}: matches differ from the plain version at {bad}")
        err = max(check(max_err(got[0], want[0]), f"K9 B={B} mu"),
                  check(max_err(got[1], want[1]), f"K9 B={B} Sigma"))
        # half the fleet out of contact: those missions keep μ and Σ bit for bit
        off = args.copy()
        off[4] = args[4].clone()
        off[4][::2] = False
        g_off = K9.fleet_tick(*off)
        torch.cuda.synchronize()
        w_off = K9.fleet_tick_reference(*off)
        if not (torch.equal(g_off[0][::2], args[0][::2]) and torch.equal(g_off[1][::2], args[1][::2])):
            raise AssertionError(f"K9 B={B}: a mission without contact changed its state")
        if not torch.equal(g_off[2], w_off[2]):
            raise AssertionError(f"K9 B={B}: matches differ from the plain version (half off)")
        err = max(err, check(max_err(g_off[0], w_off[0]), f"K9 B={B} mu (half off)"),
                  check(max_err(g_off[1], w_off[1]), f"K9 B={B} Sigma (half off)"))

        def k9():
            return K9.fleet_tick(*args)

        M, N = args[5].shape[1], args[7].shape[0]
        if not int((got[2] >= 0).sum()) > 0:
            raise AssertionError(f"K9 B={B}: no detection of tick {t_k} associated")
        res[B] = dict(err=err, ms=device_ms(k9, 30, "loc_tick_kernel"), wall_ms=wall_ms(k9, 50),
                      plain_ms=wall_ms(lambda: K9.fleet_tick_reference(*args), 5),
                      bound=bound(nbytes(*args[:10], *got), k9_flops(args[4], args[6], N)),
                      matched=int((got[2] >= 0).sum()), dets=int(args[6].sum()))
        v = res[B]
        print(f"K9 fleet_tick B={B} N={N} M={M} (tick {t_k}): {v['dets']} detections, {v['matched']} matched, "
              f"max err {v['err']:.3e}; kernel {v['ms']:.4f} ms device ({v['wall_ms']:.4f} ms per "
              f"call back to back), plain {v['plain_ms']:.3f} ms, bound {v['bound'][0]:.6f} ms "
              f"({v['bound'][1]}); half the fleet out of contact: state bitwise kept", flush=True)
    return res


def ekf15_kernel_phase(dev, tl15):
    """Phase 12: K10 against its plain version, local and global wiring."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_15state as E15
    from smarc_navigation_tpu_torch.ops import ekf15_kernels as K10

    res = {}
    for name, cfg in (("local", E15.Ekf15Config(frequency=50.0)),
                      ("global", E15.global_config(50.0))):
        (x, P), _ = E15.run_fleet(tl15.map(lambda a: a[:, :T_WARM]), cfg)
        tick_t, w = K10.stage_ticks15(tl15, cfg)
        args = (x.contiguous(), P.contiguous(), tick_t[T_WARM], w)
        got = K10.fleet15_tick(*args)
        torch.cuda.synchronize()
        want = K10.fleet15_tick_reference(*args)
        err = max(check(max_err(got[0], want[0]), f"K10 {name} x"),
                  check(max_err(got[1], want[1]), f"K10 {name} P"))
        if not torch.equal(got[1], got[1].transpose(1, 2)):
            raise AssertionError(f"K10 {name}: P not exactly symmetric")

        def k10():
            return K10.fleet15_tick(*args)

        B = x.shape[0]
        ks = [len(ix) for ix in w.sensor_idx]
        res[name] = dict(err=err, ms=device_ms(k10, 30, "ekf15_kernel"), wall_ms=wall_ms(k10, 50),
                         plain_ms=wall_ms(lambda: K10.fleet15_tick_reference(*args), 5),
                         bound=bound(nbytes(*args[:3], *got), k10_flops(args[2], w)), ks=ks,
                         applied=sum(n for _, n in applied_sensors(args[2], w)))
        v = res[name]
        print(f"K10 fleet15_tick {name} B={B} sensors k={ks} (applied {v['applied']} of "
              f"{B * len(ks)}): max err {v['err']:.3e}, P exactly "
              f"symmetric; kernel {v['ms']:.4f} ms device ({v['wall_ms']:.4f} ms per call back to "
              f"back), plain {v['plain_ms']:.3f} ms, bound {v['bound'][0]:.6f} ms ({v['bound'][1]})",
              flush=True)
    return res


def filter_slices_phase(dev):
    """Phase 13: the localization and 15-state slices, kernels vs plain on
    8 distinct missions over 100 ticks (the reference tests' stable
    localization tuning: the launch tuning amplifies every rounding)."""
    import torch

    from smarc_navigation_tpu_torch.configs import EKFLocConfig
    from smarc_navigation_tpu_torch.io import sim
    from smarc_navigation_tpu_torch.models import ekf_15state as E15
    from smarc_navigation_tpu_torch.models import ekf_localization as LOC
    from smarc_navigation_tpu_torch.parallel import fleet as FL

    t0 = time.perf_counter()
    cfg = dataclasses.replace(EKFLocConfig(), stone_offset=0.0,
                              r_diag=(1e-4,) * 3 + (1e-6,) * 3, q_diag=(0.25,) * 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ms = [sim.simulate(sim.MissionSpec(duration_s=1.98, seed=s, **LOC_SPEC)) for s in range(8)]
        tl = FL.batch_timelines([LOC.loc_timeline(m, cfg) for m in ms])
    outs = [LOC.run_fleet(tl.to(d), LOC.make_params(ms[0].landmarks, cfg, device=d), cfg)[1]
            for d in (dev, "cpu")]
    if not torch.equal(outs[0]["matches"].cpu(), outs[1]["matches"]):
        raise AssertionError("loc slice: matches differ between kernel and plain")
    loc_err = float((outs[0]["mu"].cpu() - outs[1]["mu"]).abs().max())
    if not loc_err <= POSE_TOL:
        raise AssertionError(f"loc slice: mu differs by {loc_err:.3e} > {POSE_TOL}")
    n_match = int((outs[0]["matches"] >= 0).sum())

    cl, cg = E15.Ekf15Config(frequency=50.0), E15.global_config(50.0)
    tl15 = FL.batch_timelines([E15.ekf15_timeline(sim.simulate(sim.MissionSpec(
        duration_s=1.98, seed=5 + s)), cl, include_gps=True) for s in range(8)])
    duals = [E15.run_dual_fleet(tl15.to(d), tl15.to(d), cl, cg) for d in (dev, "cpu")]
    errs = {name: float((a.cpu() - b).abs().max()) for name, a, b in (
        ("local x", duals[0][0][1]["x"], duals[1][0][1]["x"]),
        ("global x", duals[0][1][1]["x"], duals[1][1][1]["x"]),
        ("map->odom trans", duals[0][2].trans, duals[1][2].trans),
        ("map->odom rot", duals[0][2].rot, duals[1][2].rot))}
    for name, e in errs.items():
        if not e <= POSE_TOL:
            raise AssertionError(f"ekf15 dual slice: {name} differs by {e:.3e} > {POSE_TOL}")
    print(f"loc slice B=8 T={outs[0]['mu'].shape[0]}: matches equal ({n_match} matched), max mu "
          f"err {loc_err:.3e}; ekf15 dual slice B=8 T={duals[0][0][1]['x'].shape[0]}: max err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def filter_replays(dev, cfg, params, tl64, tl15):
    """Phases 14-15: the localization and 15-state replays, graphed against
    eager, then each kernel's device time over each replay; returns their
    launch counts and graph timings."""
    import torch

    from smarc_navigation_tpu_torch.io.workloads import ekf15_fleet_timelines, loc_fleet_timelines
    from smarc_navigation_tpu_torch.models import ekf_15state as E15
    from smarc_navigation_tpu_torch.models import ekf_localization as LOC
    from smarc_navigation_tpu_torch.ops import ekf15_kernels as K10
    from smarc_navigation_tpu_torch.ops import loc_kernels as K9

    # second timelines of the same shapes: another mission (and its map)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl2_np, landmarks2 = loc_fleet_timelines(cfg, 60.0, 64, seed=8)
    params2 = LOC.make_params(landmarks2, cfg, device=dev)
    tl15_2 = ekf15_fleet_timelines(E15.Ekf15Config(frequency=50.0), 120.0, 64, seed=6).to(dev)

    def tiled(x, B):
        return x.repeat((B // 64,) + (1,) * (x.dim() - 1))

    launches, graph = {}, {}
    LOC.run_fleet(tl64.map(lambda x: x[:, :20]), params, cfg)                    # warm-up
    for B in (64, 512):
        tl = tl64 if B == 64 else tl64.map(lambda x: tiled(x, B))
        tl2 = tl2_np.to(dev).map(lambda x: tiled(x, B))
        T = tl.ticks.shape[1]
        graph[f"loc{B}"] = graph_vs_eager(
            f"loc replay B={B}", lambda g: LOC.run_fleet(tl, params, cfg, graph=g),
            lambda g: LOC.run_fleet(tl2, params2, cfg, graph=g), T)
        K9.fleet_tick.launches = 0
        (final, out), ms, wall = timed(lambda: LOC.run_fleet(tl, params, cfg))
        launches[f"loc{B}"] = K9.fleet_tick.launches
        if K9.fleet_tick.launches != T:
            raise AssertionError(f"loc replay B={B}: {K9.fleet_tick.launches} K9 launches for {T} ticks")
        for name, x in (("mu", out["mu"]), ("sigma_diag", out["sigma_diag"]), ("Sigma", final.Sigma)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"loc replay B={B}: non-finite {name}")
        n_match = int(out["num_matched"].sum())
        if not n_match > 0:
            raise AssertionError(f"loc replay B={B}: no detection associated")
        steps = B * T / (ms / 1e3)
        print(f"loc replay B={B} T={T} N={params.map_pos.shape[0]} M={cfg.max_obs} (graphed): {ms:.1f} ms on the "
              f"card ({wall:.3f} s host), {ms * 1e3 / T:.1f} us/fleet tick, {steps:.0f} steps/s = "
              f"{steps / cfg.system_freq:.0f}x the {cfg.system_freq:.0f} Hz node; {n_match} "
              f"associations; launches {launches[f'loc{B}']}", flush=True)
        graph[f"loc{B}"]["share"] = device_share(
            lambda: LOC.run_fleet(tl, params, cfg), {"loc_tick_kernel": T}, ms,
            f"loc replay B={B} (graphed)")

    cl, cg = E15.Ekf15Config(frequency=50.0), E15.global_config(50.0)
    B, T = tl15.ticks.shape
    E15.run_fleet(tl15.map(lambda x: x[:, :20]), cl)                            # warm-up
    graph["ekf15"] = graph_vs_eager(
        "ekf15 replay (local)", lambda g: E15.run_fleet(tl15, cl, graph=g),
        lambda g: E15.run_fleet(tl15_2, cl, graph=g), T)
    K10.fleet15_tick.launches = 0
    ((x, P), out), ms, wall = timed(lambda: E15.run_fleet(tl15, cl))
    launches["ekf15"] = K10.fleet15_tick.launches
    if launches["ekf15"] != T:
        raise AssertionError(f"ekf15 replay: {launches['ekf15']} K10 launches for {T} ticks")
    if not (bool(torch.isfinite(out["x"]).all()) and bool(torch.isfinite(P).all())):
        raise AssertionError("ekf15 replay: non-finite state")
    print(f"ekf15 replay (local) B={B} T={T} (graphed): {ms:.1f} ms on the card ({wall:.3f} s host), "
          f"{ms * 1e3 / T:.1f} us/fleet tick, {B * T / (ms / 1e3):.0f} steps/s; launches "
          f"{launches['ekf15']}", flush=True)
    graph["ekf15"]["share"] = device_share(lambda: E15.run_fleet(tl15, cl), {"ekf15_kernel": T},
                                           ms, "ekf15 replay (local, graphed)")
    graph["ekf15_dual"] = graph_vs_eager(
        "ekf15 dual replay", lambda g: E15.run_dual_fleet(tl15, tl15, cl, cg, graph=g),
        lambda g: E15.run_dual_fleet(tl15_2, tl15_2, cl, cg, graph=g), T)
    K10.fleet15_tick.launches = 0
    (_l, _g, mo), ms_d, wall_d = timed(lambda: E15.run_dual_fleet(tl15, tl15, cl, cg))
    launches["ekf15_dual"] = K10.fleet15_tick.launches
    if launches["ekf15_dual"] != 2 * T:
        raise AssertionError(f"ekf15 dual replay: {launches['ekf15_dual']} K10 launches for {T} ticks")
    if not (bool(torch.isfinite(mo.trans).all()) and bool(torch.isfinite(mo.rot).all())):
        raise AssertionError("ekf15 dual replay: non-finite map->odom")
    print(f"ekf15 dual replay B={B} T={T} (graphed): {ms_d:.1f} ms on the card ({wall_d:.3f} s host), "
          f"{ms_d * 1e3 / T:.1f} us/fleet tick, {B * T / (ms_d / 1e3):.0f} dual pairs/s; final "
          f"map->odom |t| max {float(mo.trans[-1].norm(dim=-1).max()):.3f} m; launches "
          f"{launches['ekf15_dual']}", flush=True)
    graph["ekf15_dual"]["share"] = device_share(
        lambda: E15.run_dual_fleet(tl15, tl15, cl, cg), {"ekf15_kernel": 2 * T}, ms_d,
        "ekf15 dual replay (graphed)")
    return launches, graph


def filter_fleets(dev):
    """Phases 11-15; returns (K9 results, K10 results, (launch counts,
    graph timings))."""
    from smarc_navigation_tpu_torch.configs import EKFLocConfig
    from smarc_navigation_tpu_torch.io.workloads import ekf15_fleet_timelines, loc_fleet_timelines
    from smarc_navigation_tpu_torch.models import ekf_15state as E15
    from smarc_navigation_tpu_torch.models import ekf_localization as LOC

    cfg = EKFLocConfig()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl64_np, landmarks = loc_fleet_timelines(cfg, 60.0, 64)
    tl64 = tl64_np.to(dev)
    params = LOC.make_params(landmarks, cfg, device=dev)
    tl15 = ekf15_fleet_timelines(E15.Ekf15Config(frequency=50.0), 120.0, 64).to(dev)
    print(f"localization fleet: B=64 T={tl64.ticks.shape[1]} N={cfg.max_landmarks} M={cfg.max_obs}; "
          f"15-state fleet: B=64 T={tl15.ticks.shape[1]}", flush=True)
    k9 = loc_kernel_phase(dev, cfg, params, tl64)
    k10 = ekf15_kernel_phase(dev, tl15)
    filter_slices_phase(dev)
    return k9, k10, filter_replays(dev, cfg, params, tl64, tl15)


def main():
    import torch

    # --- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA device")
    card = card_line()
    print("card:", card, flush=True)
    dev = torch.device("cuda", 0)

    from smarc_navigation_tpu_torch import _build
    from smarc_navigation_tpu_torch.configs import EKFSlamConfig
    from smarc_navigation_tpu_torch.io.workloads import (
        combined_slam_cfg, slam_fleet_timelines)
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2

    # --- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in built.items()), flush=True)
    for name in built:
        log = (_build.BUILD / f"lib{name}.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    cfg = combined_slam_cfg()
    L, M = cfg.max_landmarks, cfg.max_obs
    params = S.make_params(cfg, device=dev)
    cfg256 = dataclasses.replace(EKFSlamConfig(), max_landmarks=256, max_obs=8)
    params256 = S.make_params(cfg256, device=dev)
    with warnings.catch_warnings():   # detection bursts beyond M are dropped,
        warnings.simplefilter("ignore")  # as in the reference workload
        tl_np = slam_fleet_timelines(cfg, 60.0, 128)
        tl8_np = slam_fleet_timelines(cfg, 9.9, 8)
        tl256_np = slam_fleet_timelines(cfg256, 60.0, L256_B)
        tl256_8_np = slam_fleet_timelines(cfg256, 9.9, 8)
    tl = tl_np.to(dev)
    tl256 = tl256_np.to(dev)
    B, T = tl.ticks.shape
    print(f"headline fleet: B={B} T={T} L={L} M={M} D={6 + 3 * L}; reference-tuned fleet: "
          f"B={L256_B} T={tl256.ticks.shape[1]} L=256 M=8 D=774", flush=True)

    # --- 3. kernels against their plain versions ------------------------------
    st, _ = S.run_fleet(tl.map(lambda x: x[:, :T_WARM]), params, cfg)
    band = S.initial_band(st.Sigma, L).contiguous()
    odom = tl.channels["odom"]
    pose_t = S._odom_pose(odom.value[:, T_WARM]).contiguous()
    valid_t = odom.valid[:, T_WARM].contiguous()
    st_p, a8 = S._fleet_predict(st, pose_t, valid_t, params)
    ev = tl.events["mbes"]
    z = ev.value[:, T_WARM].contiguous()
    zm = (ev.mask[:, T_WARM] & valid_t[:, None]).contiguous()
    new_cov = torch.tensor(S.MBES.new_lm_cov, device=dev)
    da_args = (st_p.mu[:, 0:6].contiguous(), st_p.n_active, st_p.active,
               st_p.mu[:, 6:].reshape(B, L, 3).contiguous(), st_p.Sigma, z, zm,
               torch.diagonal(params.Q_mbes), params.lambda_mbes, cfg.outlier_cost,
               cfg.mhl_dist_mbes, new_cov)
    da_kw = dict(sensor="mbes", A=a8[:, 0:6, 0:6].contiguous(),
                 r_full=a8[:, 0:6, 8:14].contiguous(), band=band)
    got = K1.da_lanes(*da_args, **da_kw)
    torch.cuda.synchronize()
    want = K1.da_lanes_reference(*da_args, **da_kw)
    k1_err = compare_da(got, want, zm, "K1 MBES")

    def k1():
        return K1.da_lanes(*da_args, **da_kw)

    k1_ms, k1_wall = device_ms(k1, 30, "da_kernel"), wall_ms(k1, 50)
    k1_plain_ms = wall_ms(lambda: K1.da_lanes_reference(*da_args, **da_kw), 3)
    # the stage reads Σ's six pose rows (Sll comes from the band)
    k1_bound = bound(nbytes(*da_args[:4], st_p.Sigma[:, 0:6], z, zm, da_kw["A"], da_kw["r_full"],
                            band, *got), k1_flops(B, L, M, 3, True))
    print(f"K1 da_lanes MBES: detections {int(zm.sum())}, do {int(got[5].sum())}, "
          f"add {int(got[6].sum())}, max err {k1_err:.3e}; kernel {k1_ms:.4f} ms device "
          f"({k1_wall:.4f} ms per call back to back), plain {k1_plain_ms:.2f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]})", flush=True)

    # FLS form: pixel detections of each mission's mapped landmarks through a
    # tilted, offset sonar mount, plus one far candidate; no predict, band on
    params_f = fls_params(S, cfg, dev)
    zfls, zfm = fls_detections(S, st_p.mu, st_p.active, params_f, M, dev)
    zfm = zfm & valid_t[:, None]
    fls_args = (st_p.mu[:, 0:6].contiguous(), st_p.n_active, st_p.active,
                st_p.mu[:, 6:].reshape(B, L, 3).contiguous(), st_p.Sigma, zfls, zfm,
                torch.diagonal(params_f.Q_fls), params_f.lambda_fls, cfg.outlier_cost,
                cfg.mhl_dist_fls, torch.tensor(S.FLS.new_lm_cov, device=dev))
    fls_kw = dict(sensor="fls", r_sb=params_f.r_fls_base, t_sb=params_f.t_fls_base,
                  band=band)
    gotf = K1.da_lanes(*fls_args, **fls_kw)
    torch.cuda.synchronize()
    wantf = K1.da_lanes_reference(*fls_args, **fls_kw)
    k1f_err = compare_da(gotf, wantf, zfm, "K1 FLS")
    k1f_ms = device_ms(lambda: K1.da_lanes(*fls_args, **fls_kw), 30, "da_kernel")
    print(f"K1 da_lanes FLS: detections {int(zfm.sum())}, do {int(gotf[5].sum())}, "
          f"add {int(gotf[6].sum())}, max err {k1f_err:.3e}; kernel {k1f_ms:.4f} ms device",
          flush=True)

    # K2 on K1's selection, with the predict, the band and the candidates
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = got
    lm_ix = 6 + 3 * slot
    k2_args = (st_p.Sigma, st_p.mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_cov,
               cand, a8, band)
    got2 = K2.sequential_update_fleet(*k2_args)                   # streamed: phase 1 + K12
    one2 = K2.sequential_update_fleet(*k2_args, streamed=False)   # the one-kernel schedule
    torch.cuda.synchronize()
    for g, o, name in zip(got2, one2, ("Sigma", "mu", "band")):
        if not bitwise(g, o):
            raise AssertionError(f"K2 at L={L}: streamed {name} differs from the one-kernel schedule's")
    want2 = K2.sequential_update_fleet_reference(*k2_args)
    errs = [max_err(got2[0], want2[0]), max_err(got2[1], want2[1]),
            max_err(band_entries(got2[2]), band_entries(want2[2]))]
    for (err, tol), name in zip(errs, ["Sigma", "mu", "band"]):
        if err > tol:
            raise AssertionError(f"K2 {name}: max err {err:.3e} > {tol:.3e}")
    if not bool((got2[0] == got2[0].transpose(1, 2)).all()):
        raise AssertionError("K2: Sigma not exactly symmetric")
    k2_err = max(e for e, _ in errs)

    def k2():
        return K2.sequential_update_fleet(*k2_args)

    k2_t = path_ms(k2, 30, ("phase1_kernel", "downdate_kernel"))
    k2_ms, k2_wall = k2_t["phase1_kernel"] + k2_t["downdate_kernel"], wall_ms(k2, 50)
    k2_one_ms = device_ms(lambda: K2.sequential_update_fleet(*k2_args, streamed=False), 30,
                          "update_kernel")
    k2_plain_ms = wall_ms(lambda: K2.sequential_update_fleet_reference(*k2_args), 10)
    k2_bound = bound(nbytes(*k2_args, *got2), k2_flops(B, 6 + 3 * L, M, 3, True))
    print(f"K2 sequential_update_fleet: max err Sigma {errs[0][0]:.3e} mu {errs[1][0]:.3e} "
          f"band {errs[2][0]:.3e}; streamed schedule phase 1 {k2_t['phase1_kernel']:.4f} + K12 "
          f"{k2_t['downdate_kernel']:.4f} = {k2_ms:.4f} ms device ({k2_wall:.4f} ms per call back "
          f"to back), one-kernel schedule {k2_one_ms:.4f} ms, plain {k2_plain_ms:.3f} ms, bound "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]}); streamed == one-kernel bitwise", flush=True)
    _, _, P1, U, V, act = K2.phase1(*k2_args)
    k12_64 = k12_phase(st_p.Sigma, U, V, P1, act, f"L={L}")

    # K3 on the mission with the most updates (Σ predicted by the plain path)
    b = int(do.sum(1).argmax())
    st_pp, _ = S._fleet_predict(st, pose_t, valid_t, params, predict_sigma=True)
    k3_args = (st_pp.Sigma[b].contiguous(), st_pp.mu[b].contiguous(), H_sel[b],
               SinvH[b], nu_sel[b], lm_ix[b], do[b], add[b], new_cov)
    got3 = K2.sequential_update(*k3_args)                          # streamed: phase 1 + K12
    one3 = K2.sequential_update_fleet(*(x[None] for x in k3_args[:8]), new_cov, streamed=False)
    torch.cuda.synchronize()
    if not (bitwise(got3[0], one3[0][0]) and bitwise(got3[1], one3[1][0])):
        raise AssertionError("K3: streamed Sigma or mu differs from the one-kernel schedule's")
    want3 = K2.sequential_update_reference(*k3_args)
    errs3 = [max_err(got3[0], want3[0]), max_err(got3[1], want3[1])]
    for (err, tol), name in zip(errs3, ["Sigma", "mu"]):
        if err > tol:
            raise AssertionError(f"K3 {name}: max err {err:.3e} > {tol:.3e}")
    k3_err = max(e for e, _ in errs3)

    def k3():
        return K2.sequential_update(*k3_args)

    k3_t = path_ms(k3, 30, ("phase1_kernel", "downdate_kernel"))
    k3_ms, k3_wall = k3_t["phase1_kernel"] + k3_t["downdate_kernel"], wall_ms(k3, 50)
    k3_one_ms = device_ms(lambda: K2.sequential_update_fleet(
        *(x[None] for x in k3_args[:8]), new_cov, streamed=False), 30, "update_kernel")
    k3_plain_ms = wall_ms(lambda: K2.sequential_update_reference(*k3_args), 10)
    k3_bound = bound(nbytes(*k3_args, *got3), k2_flops(1, 6 + 3 * L, M, 3, False))
    print(f"K3 sequential_update (mission {b}, {int(do[b].sum())} updates): max err "
          f"{k3_err:.3e}; phase 1 {k3_t['phase1_kernel']:.4f} + K12 {k3_t['downdate_kernel']:.4f} "
          f"= {k3_ms:.4f} ms device ({k3_wall:.4f} ms per call back to back), one-kernel schedule "
          f"{k3_one_ms:.4f} ms, plain {k3_plain_ms:.3f} ms, bound {k3_bound[0]:.4f} ms "
          f"({k3_bound[1]}); streamed == one-kernel bitwise", flush=True)

    # --- 3b. the slice-3 kernels at L=256 ---------------------------------------
    k256 = slam256_kernels_phase(dev, cfg256, params256, tl256)

    # --- 4. the slice against its plain version ------------------------------
    t0 = time.perf_counter()
    fin_k, out_k = S.run_fleet(tl8_np.to(dev), params, cfg)
    fin_p, out_p = S.run_fleet(tl8_np.to("cpu"), S.make_params(cfg, device="cpu"), cfg)
    for key in ("matched_mbes", "n_active"):
        if not torch.equal(out_k[key].cpu(), out_p[key]):
            raise AssertionError(f"slice: {key} differs between kernels and plain")
    pose_err = float((out_k["mu"].cpu() - out_p["mu"]).abs().max())
    if not pose_err <= POSE_TOL:
        raise AssertionError(f"slice: pose track differs by {pose_err:.3e} > {POSE_TOL}")
    print(f"slice B=8 T={out_k['mu'].shape[0]}: matched_mbes and n_active equal "
          f"({int((out_k['matched_mbes'] >= 0).sum())} matches, n_active "
          f"{out_k['n_active'][-1].tolist()}), max pose err {pose_err:.3e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    slam256_slice_phase(dev, cfg256, params256, tl256_8_np)

    # --- 5. the headline replay (main path) ------------------------------------
    S.run_fleet(tl.map(lambda x: x[:, :10]), params, cfg)      # warm-up
    torch.cuda.synchronize()
    tl_perm = tl.map(lambda x: x[torch.roll(torch.arange(B, device=dev), 1)])
    g_head = graph_vs_eager(f"headline run_fleet B={B} T={T}",
                            lambda g: S.run_fleet(tl, params, cfg, graph=g),
                            lambda g: S.run_fleet(tl_perm, params, cfg, graph=g), T)
    counters = [K1.da_lanes, K2.sequential_update_fleet, K2.sequential_update,
                K2.sequential_update_marginal_fleet, K2.symmetric_downdate, K1.hungarian_lanes]
    for f in counters:
        f.launches = 0
    (final, out), ms, wall = timed(lambda: S.run_fleet(tl, params, cfg))
    if (K1.da_lanes.launches != T or K2.sequential_update_fleet.launches != T
            or K2.symmetric_downdate.launches != T):
        raise AssertionError(
            f"headline: {K1.da_lanes.launches} DA, {K2.sequential_update_fleet.launches} "
            f"update and {K2.symmetric_downdate.launches} downdate launches for {T} ticks")
    for name, x in (("mu", final.mu), ("Sigma", final.Sigma), ("out mu", out["mu"])):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"headline: non-finite {name}")
    n_act = final.n_active.cpu()
    if not int((n_act > 0).sum()) >= B // 2:
        raise AssertionError(f"headline: too few missions mapped anything: {n_act}")
    us_tick = ms * 1e3 / T
    print(f"headline run_fleet B={B} T={T} (graphed): {ms:.1f} ms on the card ({wall:.2f} s host), "
          f"{us_tick:.1f} us/fleet tick, {B * T / (ms / 1e3):.0f} steps/s; "
          f"n_active min {int(n_act.min())} mean {float(n_act.float().mean()):.1f} "
          f"max {int(n_act.max())}", flush=True)

    # --- 6. single-mission step through K3 --------------------------------------
    mask0 = tl_np.events["mbes"].mask[0]
    k = int(next(i for i in range(T - 1, 0, -1) if mask0[i].any()))
    st0 = S.SlamState(*(x[0].contiguous() for x in final))
    tick = tl.map(lambda x: x[0, k])
    s_k, o_k = S.step(cfg, params, st0, tick)                        # auto -> K3
    s_p, o_p = S.step(cfg, params, st0, tick, update_mode="full")    # plain dense
    torch.cuda.synchronize()
    if not torch.equal(o_k["matched_mbes"], o_p["matched_mbes"]):
        raise AssertionError("step: matched_mbes differs between K3 and the dense path")
    err, tol = max_err(s_k.mu, s_p.mu)
    if err > tol:
        raise AssertionError(f"step: mu differs by {err:.3e} > {tol:.3e}")
    launches = {f.__name__: f.launches for f in counters}
    if launches["sequential_update"] < 1:
        raise AssertionError("step: K3 was not launched")
    print(f"step (mission 0, tick {k}): matched {o_k['matched_mbes'].tolist()}, "
          f"mu err vs dense {err:.3e}; launches {launches}", flush=True)
    g_head["share"] = device_share(lambda: S.run_fleet(tl, params, cfg),
                                   {"da_kernel": T, "phase1_kernel": T, "downdate_kernel": T},
                                   ms, "headline run_fleet (graphed)")

    # --- 5b-5c. the L=256 replays in both semantics -----------------------------
    l256, g256 = slam256_replays(dev, cfg256, params256, tl256, counters)

    # --- 7-10. the PF kernels, slice, headline and the combined mission ------
    pk, pf_launch, pt_launch = pf_main_paths(dev, cfg, params, counters)

    # --- 11-15. the localization and 15-state fleets ----------------------------
    k9, k10, (fl_launch, g_filters) = filter_fleets(dev)

    def entry(name, source, replaces, n, err, ms_, plain, bnd, library=None, **extra):
        return dict(name=name, route="cuda", source=f"smarc_navigation_tpu_torch/csrc/{source}",
                    replaces=f"smarc_navigation_tpu/ops/{replaces}", launches=n,
                    max_abs_err=err, ms=ms_, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                    library_ms=library, **extra)

    k12_256 = k256["K12"]

    kernels = [
        entry("da_lanes", "slam_da.cu", "slam_da_kernels.py:581", launches["da_lanes"],
              max(k1_err, k1f_err, k256["K1_pose_rows"]["err"]), k1_ms, k1_plain_ms, k1_bound),
        # K2 and K3: the streamed path's device time, phase 1 + K12
        entry("sequential_update_fleet", "slam_update.cu", "slam_kernels.py:791",
              launches["sequential_update_fleet"], max(k2_err, k256["K2_774"]["err"]), k2_ms,
              k2_plain_ms, k2_bound, phase1_ms=k2_t["phase1_kernel"],
              downdate_ms=k2_t["downdate_kernel"], one_kernel_ms=k2_one_ms,
              D774=dict(phase1_ms=k256["K2_774"]["phase1_ms"], downdate_ms=k12_256["ms"],
                        one_kernel_ms=k256["K2_774"]["ms"], bound_ms=k256["K2_774"]["bound"][0])),
        entry("sequential_update", "slam_update.cu", "slam_kernels.py:213",
              launches["sequential_update"], k3_err, k3_ms, k3_plain_ms, k3_bound,
              phase1_ms=k3_t["phase1_kernel"], downdate_ms=k3_t["downdate_kernel"],
              one_kernel_ms=k3_one_ms),
        entry("sequential_update_marginal_fleet", "slam_marginal.cu", "slam_kernels.py:1124",
              l256["marginal"]["sequential_update_marginal_fleet"], k256["K4"]["err"],
              k256["K4"]["ms"], k256["K4"]["plain_ms"], k256["K4"]["bound"]),
    ] + [
        entry(name, src, rep, cnt[name], pk[k]["err"], pk[k]["ms"], pk[k]["plain_ms"], pk[k]["bound"])
        for k, name, src, rep, cnt in (
            ("K5", "predict_call_multi", "pf_predict.cu", "pf_kernels.py:820", pf_launch),
            ("K6", "predict_call", "pf_predict.cu", "pf_kernels.py:865", pt_launch),
            ("K7", "expand_gather_call", "pf_resample.cu", "pf_kernels.py:562", pf_launch),
            ("K8", "jitter_moments_call", "pf_resample.cu", "pf_kernels.py:472", pf_launch))
    ] + [
        entry("hungarian_lanes", "slam_da.cu", "slam_da_kernels.py:616",
              l256["full"]["hungarian_lanes"], k256["K11"]["err"], k256["K11"]["ms"],
              k256["K11"]["plain_ms"], k256["K11"]["bound"]),
        # K12 at the L=64 headline (launches: phases 5-6), and at L=256
        entry("symmetric_downdate", "slam_downdate.cu", "slam_kernels.py:807",
              launches["symmetric_downdate"], max(k12_64["err"], k12_256["err"]), k12_64["ms"],
              k12_64["plain_ms"], k12_64["bound"], k12_64["library_ms"],
              one_row_ms=k12_64["one_row_ms"], copy_ms=k12_64["copy_ms"],
              L256=dict(launches=l256["full"]["symmetric_downdate"], max_abs_err=k12_256["err"],
                        ms=k12_256["ms"], plain_ms=k12_256["plain_ms"],
                        bound_ms=k12_256["bound"][0], bound_by=k12_256["bound"][1],
                        library_ms=k12_256["library_ms"], one_row_ms=k12_256["one_row_ms"],
                        copy_ms=k12_256["copy_ms"])),
        # K9 at the loc-fleet64 replay's shape; K10 in the local wiring of
        # the ekf15-fleet64 replay (its dual replay launches it 2T times)
        entry("fleet_tick", "loc_tick.cu", "loc_kernels.py:326", fl_launch["loc64"],
              max(v["err"] for v in k9.values()), k9[64]["ms"], k9[64]["plain_ms"], k9[64]["bound"]),
        entry("fleet15_tick", "ekf15_tick.cu", "ekf15_kernels.py:264", fl_launch["ekf15"],
              max(v["err"] for v in k10.values()), k10["local"]["ms"], k10["local"]["plain_ms"],
              k10["local"]["bound"]),
    ]
    graphed = {"slam-fleet128-L64": g_head, "slam-fleet32-L256-full": g256["full"],
               "slam-fleet32-L256-marginal": g256["marginal"], "loc-fleet64": g_filters["loc64"],
               "loc-fleet512": g_filters["loc512"], "ekf15-fleet64": g_filters["ekf15"],
               "ekf15-dual64": g_filters["ekf15_dual"]}
    for name, g in graphed.items():
        print(f"graph summary {name}: us/tick first call {g['first_us']:.1f}, steady "
              f"{g['steady_us']:.1f}, eager {g['eager_us']:.1f}; path kernels "
              f"{100 * g['share']:.1f} % of the steady replay; graphed == eager bitwise", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
