#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one GPU: the EKF-SLAM
fleet replay at the headline shape (L=64) and at the reference-tuned L=256
shape in both covariance semantics, the 2^20-particle PF replay, the
combined PF + SLAM mission, the EKF-localization fleet, the 15-state
dual-EKF fleet and the closed-loop raycast fleet at B=1024; dead reckoning
and the SLAM + PF mission fleet against their CPU runs; the mission CLI;
the multi-device layer with four shards on the one card.

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
     ``sequential_update``, each phase 1 + K12 ``symmetric_downdate``, Σ
     exactly symmetric; K12 on phase 1's factors, timed
     beside ``torch.baddbmm`` and beside its memory path alone (K12 at one
     factor row, ``Tensor.clone`` of Σ); K11 ``hungarian_lanes`` on K1's own
     (B, L+M, M) cost tables (the JV's share of K1) and K1 on one mission (the
     combined mission's shape), each beside its bound; discrete outputs
     exact, floats within 1e-4 of each output's scale;
 3b. the slice-3 kernels against their plain versions at L=256, B=32
     (D=774), on the states of the reference-tuned fleet after 50 ticks in
     each covariance semantics: K1 in its pose-rows and its full-Σ form
     (MBES with predict and band, FLS), each beside its bound, K4
     ``sequential_update_marginal_fleet`` (dim 3 and 2, with and without a8;
     and at M=16, ``EKFSlamConfig()``'s max_obs, on the DA selection of the
     same fleet replayed at M=16), K11 ``hungarian_lanes`` on the DA stage's
     own (B, L+M, M) cost tables, K2 at D=774 (Σ exactly symmetric) and K12
     ``symmetric_downdate`` on K2's phase-1 factors, timed beside
     ``torch.baddbmm`` computing Σ − ½(UᵀV + VᵀU) (the yardstick; the port
     never calls it);
 3c. K1 (pose-rows and full-Σ forms, MBES and FLS) and K11 past the register
     JV: the L=256 fleet's state (B=4) padded with inactive slots to
     L + M = 1025 and 2048, L=1200 (past the shared memory of the kernel
     before the register JV) and L=900 at M=64 (the tables alone overflow
     shared memory), against their plain versions (discrete outputs exact),
     and on the unpadded state the scratch form bitwise the register form;
  4. the slice against its plain version: ``run_fleet`` of 8 missions over
     100 ticks on the card (kernels) and on the CPU (plain versions);
 4b. the same at L=256 for ``run_fleet(update_mode="marginal")`` and the
     full ``run_fleet`` (phase 1 + K12);
  5. the headline replay (``slam_fleet_timelines(combined_slam_cfg(), 60, 128)``
     through ``run_fleet``), timed with CUDA events; K1, K2 (phase 1) and
     K12 must each have launched once per tick;
  6. one single-mission ``step`` on the card: K15, then K1 + K2 (phase 1 +
     K12) at B=1, each once, against the same step with K15's plain twin
     and the dense update;
 6b. K15 ``online_predict`` (the online step's motion predict) at B=1,
     L=64 and L=256, against its plain twin ``predict(state, odom_pose(v),
     params)`` on the card, with 13-wide odometry, odometry steps of a few
     cm to m, and attitudes at ±π and pitch π/2: μ's position,
     ``mu_auv_odom``, Σ past the pose rows and columns and Σ's attitude
     rows and columns (R's and zeros) bitwise, the attitude within 2 ulp,
     Σ's position rows within 1e-6 of each block's largest entry; its
     device time, the host's time per call back to back beside the twin's,
     one launch a call;
 5b. the L=256 full replay (``slam_fleet_timelines(cfg256, 60, 32)``, T=601):
     K1, K2 (phase 1) and K12 once per tick;
 5c. the L=256 marginal replay on the same timeline: K1 and K4 once per tick;
  7. each PF kernel against its plain version on the card at N = 2^20, on
     the 60 s PF mission's bank and tick 0-11 parameters: the generator's
     uniforms bitwise; K5 ``predict_call_multi`` (nticks < K, rows past
     nticks zero) and K6 ``predict_call`` (and K6 == K5 at K = 1 bitwise);
     K7 ``expand_gather_call`` on healthy, degenerate and zero-run weights
     (ancestors and bank exact; with the jitter within tolerance) and K8
     ``jitter_moments_call`` (and K7 with the jitter == K8 after K7,
     bitwise); K5 timed over nticks 0, 1, 5 and 10 (the intercept is the
     bank's bytes, the slope the tick loop), K7 timed by weights, with and
     without the jitter, beside ``torch.repeat_interleave`` of the bank by
     the counts (K7's ``library_ms``); K13 ``gps_weights_call`` and K14
     (``resampling.systematic_counts``) bitwise their plain versions on the
     same inputs, at 2^20, at a bank of 10^6 that does not tile by
     CDF_BLOCK and (K14) at the SLAM + PF fleet's (8, 1024) banks, each
     timed beside its plain version;
  8. the PF slice against its plain version: ``run_fast_segmented`` and
     ``run_fast`` at N = 2^20 over a 10 s mission with every noise std zero
     but the initial spread, on the card (kernels) and on the CPU (plain
     versions): mean track within PF_MEAN_TOL, ``updated`` exact; then with
     the noise on, the two paths' banks on the card bitwise equal;
  9. the headline PF replay: ``run(..., scheme="systematic",
     use_pallas=True)`` on the 60 s mission at N = 2^20, timed; K5 must have
     launched once per segment and K7, K13 and K14 once per GPS update; then
     the per-tick path (``segmented=False``), K6 once per tick;
 10. the combined mission ``run_combined`` on ``combined_workload(cfg, 60)``,
     timed; K1/K2/K12 once per event tick, K5/K7/K13/K14 as in phase 9;
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
 16. K1 and K2 (phase 1 + K12) at the raycast fleet's shape (B=1024 missions,
     L=32 slots, M=8, D=102), on its state after 50 ticks: K1 in its MBES
     form with the band and no predict (the raycast tick predicts Σ in
     PyTorch), K2 (phase 1 + K12), each against its plain version as in
     phase 3, K12 beside ``torch.baddbmm``; device
     times and bounds;
 17. the raycast fleet ``raycast_fleet_inputs(1024, 301)`` (``bench.py``'s
     raycast cell: 64 beams, 16 rocks per mission, the seed-1 mission's
     ground truth) through ``run_raycast_fleet``'s kernel path, graphed
     against eager (the second timeline: another rock field), timed as the
     median of five graphed replays (every reading printed); K1, K2 (phase
     1) and K12 once per tick; their shares and the busy share; its first 8
     missions against the same missions replayed at B=8 (n_active exact,
     poses within POSE_TOL);
 18. card against CPU at small sizes: the raycast kernel path (B=8, T=40)
     on the card against the CPU and against the card's dense path
     (n_active exact, poses within POSE_TOL); ``run_sam_dr_vectorized`` on
     ``sam_dr_fleet_timelines(120, 256)`` (T=6001) against the CPU within
     DR_TOL, timed per fleet tick (and as the slope between the 15 s and
     120 s replays, as ``bench.py`` times it); the SLAM + PF fleet
     ``parallel.fleet.run_fleet`` (8 missions, 40 ticks, N=1024, both PF
     schemes) on the card against the CPU with the same seeds:
     associations, n_active and GPS updates exact, poses within POSE_TOL,
     the PF mean within FLEET_PF_TOL; K14 once a tick on the card with the
     systematic scheme, never with the residual one;
 19. the SLAM + PF fleet ``parallel.fleet.run_fleet`` at the headline's
     width (B=128, L=64, M=8, the first 101 ticks of its timeline) with
     1024 particles a mission and the residual resampler, graphed against
     eager (the second timeline: the missions rotated), timed as the median
     of five graphed replays; K1, K2 (phase 1) and K12 once per tick; their
     shares, the busy share and the replay's 12 heaviest kernels.
 20. the mission CLI (``smarc_navigation_tpu_torch.run``) on the card, at
     its defaults: (a) the native host library builds; its JV reaches
     scipy's optimum on random tables and equals ``assignment.hungarian``
     on tables with exact ties; its binner is bitwise the Python loop on the
     sample log's MBES stream; (b) ``run.main(["replay", "--log",
     "data/sample_mission.npz"])`` (T=901, L=64, M=8): K1 and K2 (phase 1
     + K12) once per tick with an MBES burst, counted from the log's
     timeline, K3 never, K15 once per tick;
     ``ekf_slam.run`` of the log on the card against the CPU over its
     first 30 s (matched_mbes exact, poses within POSE_TOL), and the same
     command with ``--device cpu`` on the log's first 30 s against the
     report of the card run's first 30 s (n_landmarks_mapped exact, pose
     metrics within POSE_TOL); (c) ``demo --duration
     60`` (K1 and K2 launched), and ``demo --duration 30`` on the card and the
     CPU (n_landmarks_mapped exact, final and mean error within POSE_TOL);
     (d) ``pf --particles 1048576 --pallas``: K5 once per segment and K7,
     K13 and K14 once per GPS update in each of the CLI's two replays, xy_err_mean_m
     under PF_CLI_ERR_M, beside the dense path's at the same N; (e)
     ``io.replay.run_chunked`` of the single-mission SLAM step on the log
     (chunks of 128, a checkpoint after each) bitwise ``ekf_slam.run`` on
     the card (final state and outputs), a resume from the last checkpoint
     but one bitwise the tail, a NaN-injecting step raising
     ``ReplayError``, and ``profile_replay``'s trace naming K1's and K2's
     kernels.
 21. the multi-device layer (``parallel/mesh.py``, a grid of devices driven
     from this process), every mesh's shards on the one card: (a) K7's
     window form (``expand_gather_window_call``) at a shard's shape of the
     2^20 bank split four ways (n_out = 2^18, n_in = 2^18 + 2·4096), on
     healthy, degenerate and zero-run counts, for a left-edge, an interior
     and a right-edge shard, exactly equal to its plain version and to the
     whole-bank K7's columns; the whole-bank K7 bitwise the window form at
     out_off 0; K5 and K6 at 2^18 with idx_off = s·2^18, four shards side
     by side bitwise the 2^20 call; K8 at a shard's shape; (b)
     ``run_fast_segmented(pmesh=make_mesh(particle=4))`` on pf-1M-60s
     bitwise the unsharded replay (bank, mean, cov), K5, the window form
     and K8 four times per segment / GPS update (K7, K13 and K14 never),
     timed beside the unsharded
     replay (medians of three), and a forced exact-branch resample bitwise
     the unsharded gather; (c) ``ekf_slam.run_fleet(device_mesh=
     make_mesh(mission=4))`` at the headline (T=601, each mission shard
     graphed), (d) ``fleet.run_fleet`` over make_mesh(mission=2,
     particle=2) at slam-pf-fleet128's width (T=51, systematic) and
     ``run_raycast_fleet(device_mesh=make_mesh(mission=4))`` at B=1024
     (T=76), each bitwise its unsharded run, with K1, K2 (phase 1) and K12
     once per tick and mission shard. One card measures no scaling: these
     times are what four shards cost on one card.
Phases 5, 5b, 5c, 14, 15, 17 and 19 run each replay's tick loop as a cached
CUDA graph (``utils/graphs.py``), its default on the card. Before each of
those nine replays is timed, its eager loop (``graph=False``) runs on the same
inputs; the first graphed call (eager warm-up, capture and instantiate),
three replays and a replay of the cached graph on a second timeline of the
same shape (the missions permuted, or another seed's mission and map) must
each be bitwise the eager loop's result on the same inputs: every output
and the final state. Each prints µs per tick of the first call, the median
replay and the eager call; the timed replay is a cache hit, and the
profiled one after it gives each path kernel's share of it and the card's
busy share (all kernels' device time over the replay time).
Every kernel's ``ms`` is its device time from ``torch.profiler`` (the
CUPTI trace of 30 launches); K2's and K3's are phase 1 + K12, K7's all
the device work of a call (its kernel
and the wrapper's zero fill of its group counters; the kernel alone in
``kernel_ms``), and K12's line holds its L=64, L=256 and B=1024 numbers;
the back-to-back wall time per wrapper call is printed beside it, and
``plain_ms`` is the plain version's back-to-back time on the card; K1's
entry also holds its FLS form, one mission, K11 on its tables, the L=256
forms, the raycast fleet's B=1024 and its launches on each main path (the
combined mission's, the raycast fleet's and the SLAM + PF fleet's too),
K2's and K12's their B=1024 times and launches by path, K4's its time at
M=16, K1's, K2's, K3's (none since the step runs K1 + K2) and K12's their
launches on the CLI's replay and demo and the chunked replay, K5's and
K7's on the CLI's pf;
``library_ms`` (K7's ``torch.repeat_interleave``, K12's ``torch.baddbmm``) is the device time of all
the kernels of one library call, from the same profiler. The
kernel launch counts are reset just before each main path (phases 5, 5b,
5c, 9, 9b, 10, 14, 15, 17, 19 and 21b-d) and read just after it. K8 and K7's window form take their launches from the
particle-sharded PF replay (21b), their only caller; K13's and K14's are
the headline PF replay's (phase 9), with their counts on the other PF paths
(9b, 10, 18's systematic fleet, 20d, 21b) beside them; K11 has none on any
path (the reference calls it from tests only; its JV core runs inside
K1), so its count is 0. ``bound_ms`` is the largest of the bytes
each kernel must move (inputs read once, outputs written once) over
3.35 TB/s, its float operations over 67 TFLOP/s (H100 SXM data sheet) and
the PF generator's integer operations by pipe: shifts, xors and adds over
the integer ALU's 132 SMs x 64 lanes x 1.98 GHz, multiplies (IMAD) on the
FMA pipe beside the float operations, computed from this run's inputs (K9's only for the valid detections of the
missions whose tick runs, K10's only for the applied sensors). The second-to-last line is a JSON object
with each kernel's launches, error, times and bound; the last line is the
device JSON.
"""

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

POSE_TOL = 1e-2   # slice vs plain over 100 ticks (the reference's fleet-vs-dense bound)
KERNEL_RTOL = 1e-4  # float outputs: max |kernel - plain| <= 1e-4 * max(1, max|plain|)
# PF slice vs plain over 101 ticks at 2^20 particles: the special-function
# unit's log and sin/cos against torch's (~2^-21 absolute) and a few
# stratum-boundary ancestor flips move the bank mean by far less than a
# millimetre
PF_MEAN_TOL = 1e-3
PF_N = 1 << 20
L256_B = 32        # the reference's L=256 fleet (bench.py sec_slam256)
T_WARM = 50        # ticks replayed before a kernel phase takes the fleet's state
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
# H100 SXM integer ALU (shifts, logic, adds): 64 lanes per SM per clock, 132 SMs, 1.98 GHz
ALU_OPS = 132 * 64 * 1.98e9


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


def names(key: str, name: str) -> bool:
    """Whether a profiler record's key names the function ``name`` (a whole
    identifier: ``da_kernel`` is not ``searchsorted_cuda_kernel``)."""
    return re.search(rf"(?<![A-Za-z0-9_]){name}(?![A-Za-z0-9_])", key) is not None


def path_ms(fn, n, kernels):
    """{name fragment: mean device ms per launch} of the CUDA kernels of
    ``kernels``, each launched once per call of fn(), over n calls (after
    one warm-up), from one torch.profiler trace. The trace may drop records
    (it never invents one), once all 30 of K7's cooperative launches: a
    trace that holds none of a kernel's is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = {k: [0.0, 0] for k in kernels}
        for e in prof.key_averages():
            for k in kernels:
                if names(e.key, k) and e.self_device_time_total > 0:
                    seen[k][0] += e.self_device_time_total
                    seen[k][1] += e.count
        if all(1 <= count for _, count in seen.values()):
            break
    for k, (total_us, count) in seen.items():
        if not 1 <= count <= n:
            raise AssertionError(f"profiler saw {count} launches of {k}, expected {n}")
    return {k: total_us / count / 1e3 for k, (total_us, count) in seen.items()}


def call_device_ms(fn, n):
    """Mean device time (ms) of all the work one call of fn() puts on the
    card (every kernel and copy it launches), over n calls (after one
    warm-up), from one torch.profiler trace: a library call's device time,
    on the clock of ``device_ms``. Each kernel's mean per launch times its
    launches per call, so that a record the trace drops biases nothing; a
    trace that holds no device record at all is taken again, up to three
    times, as in ``path_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total / e.count * max(1, round(e.count / n))
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.count > 0)
        if total_us > 0:
            break
    if total_us <= 0:
        raise AssertionError("profiler saw no device time")
    return total_us / 1e3


def device_ms(fn, n, kernel):
    """Mean device time (ms) of the CUDA kernel whose name contains
    ``kernel`` over n calls of fn() (after one warm-up), averaged over the
    launches the trace recorded."""
    return path_ms(fn, n, (kernel,))[kernel]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops, int_ops=(0, 0)):
    """(least time in ms, what bounds it) for moving n_bytes and doing
    flops float operations and int_ops = (ALU ops, IMADs) integer ones on
    the card. The ALU ops take the integer ALU; an IMAD issues on the FMA
    pipe's heavy half (64 lanes per SM per clock) and a float instruction on
    either half (128 lanes, two flops an FMA), so that pipe needs at least
    (2 IMADs + flops) over the float rate."""
    alu, imad = int_ops
    tb, tf, ti = n_bytes / HBM_BYTES_PER_S, (flops + 2 * imad) / F32_FLOPS, alu / ALU_OPS
    return max(tb, tf, ti) * 1e3, ("bytes" if tb >= max(tf, ti) else "operations")


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
                    # the motion integration, the moment sums)
PF_JITTER_FLOPS = 40  # the resample jitter and moment sums per particle
# Integer ops of one generator uniform, mix32(mix32(idx ^ key) + key) >> 8,
# by pipe: on the ALU 7 shifts, 7 xors and the add of the key; on the FMA
# pipe the 4 multiplies (2 per mix32). A Box-Muller normal pair draws two
# uniforms.
PF_UNIFORM_ALU_OPS = 15
PF_UNIFORM_IMADS = 4


def pf_int_ops(n_particle_ticks, nxy, nyaw):
    """(ALU ops, IMADs) of the generator: two uniforms per noise row pair on."""
    uniforms = n_particle_ticks * 2 * (int(nxy) + int(nyaw))
    return uniforms * PF_UNIFORM_ALU_OPS, uniforms * PF_UNIFORM_IMADS


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


def k1_case(what, args, kw, z_mask, dim):
    """K1 on one input set: the kernel against its plain version
    (``compare_da``), its device time and its bound from these inputs (the
    stage reads Σ's six pose rows either way; Sll comes from the band)."""
    import torch

    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1

    got = K1.da_lanes(*args, **kw)
    torch.cuda.synchronize()
    err = compare_da(got, K1.da_lanes_reference(*args, **kw), z_mask, f"K1 {what}")
    rows = kw["pose_rows"] if kw.get("pose_rows") is not None else args[4]
    B, L, M = args[2].shape[0], args[2].shape[1], args[5].shape[1]
    bnd = bound(nbytes(*args[:4], rows[:, 0:6], args[5], args[6], kw.get("A"), kw.get("r_full"),
                       kw.get("band"), *got), k1_flops(B, L, M, dim, kw.get("A") is not None))
    res = dict(err=err, ms=device_ms(lambda: K1.da_lanes(*args, **kw), 30, "da_kernel"),
               bound=bnd, shape=(B, L, M))
    print(f"K1 da_lanes {what} B={B} L={L} M={M}: detections {int(z_mask.sum())}, do "
          f"{int(got[5].sum())}, add {int(got[6].sum())}, max err {err:.3e}; kernel "
          f"{res['ms']:.4f} ms device, bound {bnd[0]:.5f} ms ({bnd[1]})", flush=True)
    return res, got


def k11_case(what, cost, want_ctr):
    """K11 on the DA stage's own cost tables: col_to_row exactly the plain
    version's and the DA kernel's; device time, back-to-back time, plain
    time and bound."""
    import torch

    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1

    ctr = K1.hungarian_lanes(cost)
    torch.cuda.synchronize()
    if not (torch.equal(ctr, K1.hungarian_lanes_reference(cost)) and torch.equal(ctr, want_ctr)):
        raise AssertionError(f"K11 {what}: col_to_row differs from the plain version")
    B, R, C = cost.shape

    def k11():
        return K1.hungarian_lanes(cost)

    res = dict(err=0.0, ms=device_ms(k11, 30, "jv_kernel"), wall_ms=wall_ms(k11, 50),
               plain_ms=wall_ms(lambda: K1.hungarian_lanes_reference(cost), 3),
               bound=bound(nbytes(cost, ctr), 4 * B * C * R), shape=(B, R, C))
    print(f"K11 hungarian_lanes {what} B={B} R={R} C={C}: col_to_row exact; kernel "
          f"{res['ms']:.4f} ms device ({res['wall_ms']:.4f} ms per call back to back), plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound'][0]:.5f} ms ({res['bound'][1]})",
          flush=True)
    return res


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
                     bound=bound(nbytes(parts, par16, seeds, *k5()), n * nt * PF_TICK_FLOPS,
                                 pf_int_ops(n * nt, nxy, nyaw)))
    # the split of K5's time: the intercept over nticks is the bank's bytes,
    # the slope the tick loop's work per tick of 2^20 particles
    sweep = {t: device_ms(lambda: PK.predict_call_multi(parts, par16, seeds, nxy, nyaw, nticks=t),
                          30, "predict_kernel") for t in (0, 1, 5, 10)}
    slope, icpt = np.polyfit(list(sweep), list(sweep.values()), 1)
    res["K5"]["nticks_ms"] = {str(t): v for t, v in sweep.items()}
    res["K5"]["fit"] = dict(intercept_ms=float(icpt), ms_per_tick=float(slope))
    print("K5 over nticks: " + ", ".join(f"{t}: {v * 1e3:.2f} us" for t, v in sweep.items())
          + f"; fit {icpt * 1e3:.2f} us + {slope * 1e3:.3f} us per tick", flush=True)

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
                     bound=bound(nbytes(parts, par16[0], seeds[0], *k6()), n * PF_TICK_FLOPS,
                                 pf_int_ops(n, nxy, nyaw)))

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
    k7_by = {}
    for name, w in (("healthy", w_healthy), ("degenerate", w_deg), ("zero-run", w_zr / 128)):
        m_cum = RS.systematic_counts(w, pre.res_u[t_up])
        got = PK.expand_gather_call(m_cum, bank)
        torch.cuda.synchronize()
        if not torch.equal(got, PK.expand_gather_call_reference(m_cum, bank)):
            raise AssertionError(f"K7 ({name}): gathered bank differs from the plain version")
        k7_by[name] = dict(
            jitter_ms=device_ms(lambda: PK.expand_gather_call(m_cum, bank, jsd, seed), 30,
                                "gather_kernel"),
            no_jitter_ms=device_ms(lambda: PK.expand_gather_call(m_cum, bank), 30,
                                   "gather_kernel"))
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

    # the yardstick of K7 without the jitter: torch.repeat_interleave of the
    # bank by the counts (the same function; the port never calls it)
    counts = torch.diff(m_h, prepend=m_h.new_zeros(1))
    if not torch.equal(torch.repeat_interleave(bank, counts, dim=1, output_size=n), g_h):
        raise AssertionError("repeat_interleave differs from K7 without the jitter")
    jit_ops = pf_int_ops(n, True, True)
    # K7's ms: all the device work of a call, its kernel and the wrapper's
    # zero fill of the group counters (torch.zeros: a FillFunctor kernel)
    t7 = path_ms(k7, 30, ("gather_kernel", "FillFunctor"))
    res["K7"] = dict(err=e7, ms=sum(t7.values()), wall_ms=wall_ms(k7, 50),
                     kernel_ms=t7["gather_kernel"],
                     plain_ms=wall_ms(lambda: PK.expand_gather_call_reference(
                         m_h, bank, jsd, seed), 10),
                     bound=bound(nbytes(m_h, bank, jsd, *k7()), n * PF_JITTER_FLOPS, jit_ops),
                     library_ms=call_device_ms(lambda: torch.repeat_interleave(
                         bank, counts, dim=1, output_size=n), 30),
                     no_jitter=dict(ms=k7_by["healthy"]["no_jitter_ms"],
                                    bound=bound(nbytes(m_h, bank, g_h), 0)),
                     by_weights=k7_by)
    res["K8"] = dict(err=e8, ms=device_ms(k8, 30, "jitter_kernel"), wall_ms=wall_ms(k8, 50),
                     plain_ms=wall_ms(lambda: PK.jitter_moments_call_reference(
                         g_h, jsd, seed), 10),
                     bound=bound(nbytes(g_h, jsd, *k8()), n * PF_JITTER_FLOPS, jit_ops))
    res.update(update_kernels(dev, bank, gps, params, pre.res_u[t_up], w_deg))
    for k, v in res.items():
        print(f"{k}: max err {v['err']:.3e}; kernel {v['ms']:.4f} ms device "
              f"({v['wall_ms']:.4f} ms per call back to back), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]})"
              + (f" (nticks {v['nticks']})" if "nticks" in v else ""), flush=True)
    k7 = res["K7"]
    print(f"K7 (healthy weights): with the jitter {k7['ms'] * 1e3:.2f} us device per call ("
          f"the kernel alone {k7['kernel_ms'] * 1e3:.2f} us), without "
          f"{k7['no_jitter']['ms'] * 1e3:.2f} us (bound {k7['no_jitter']['bound'][0] * 1e3:.2f} "
          f"us); torch.repeat_interleave {k7['library_ms'] * 1e3:.2f} us; by weights "
          + ", ".join(f"{k} {v['jitter_ms'] * 1e3:.2f} / {v['no_jitter_ms'] * 1e3:.2f} us"
                      for k, v in k7_by.items()), flush=True)
    print("generator: kernel uniforms bitwise equal to torch; K6 == K5(K=1) and "
          "K7(jitter) == K8(K7) bitwise; K7 ancestors exact on healthy, degenerate "
          "and zero-run weights", flush=True)
    return res


UPD_NONTILING = 10 ** 6  # phase 7: K13 / K14 at a bank that does not tile by CDF_BLOCK
UPD_FLEET = (8, 1024)     # phase 7: K14 at the SLAM + PF fleet's banks (phase 18)


def update_kernels(dev, bank, gps, params, u, w_deg):
    """Phase 7's K13 and K14 (the GPS update's weights and counts), each
    bitwise its plain version on the same inputs and timed beside it: at
    the main path's 2^20, at a bank of 10^6 that does not tile by
    CDF_BLOCK (the plain version is what the card ran before them) and,
    for K14, at the SLAM + PF fleet's (8, 1024) banks. Returns {"K13": ...,
    "K14": ...} with the 2^20 numbers and the others under ``non_tiling``
    and ``fleet``."""
    import torch

    from smarc_navigation_tpu_torch.ops import pf_kernels as PK
    from smarc_navigation_tpu_torch.ops import resampling as RS

    def k13(b):
        got = PK.gps_weights_call(b, gps, params)
        torch.cuda.synchronize()
        if not bitwise(got, PK.gps_weights_call_reference(b, gps, params)):
            raise AssertionError(f"K13 at N={b.shape[1]}: weights differ from the plain version")
        return got, dict(
            n=b.shape[1], err=0.0,
            ms=device_ms(lambda: PK.gps_weights_call(b, gps, params), 30, "gps_weights_kernel"),
            wall_ms=wall_ms(lambda: PK.gps_weights_call(b, gps, params), 50),
            plain_ms=wall_ms(lambda: PK.gps_weights_call_reference(b, gps, params), 10),
            bound=bound(nbytes(b[0:3], got), 0))

    def k14(w, uu, kernel):
        for v in (uu, torch.zeros_like(uu), torch.full_like(uu, 1.0 - 2.0 ** -6)):
            got = RS.systematic_counts(w, v)
            torch.cuda.synchronize()
            if not bitwise(got, RS.systematic_counts_reference(w, v)):
                raise AssertionError(f"K14 at {tuple(w.shape)}, u {v}: counts differ from the "
                                     f"plain version")
        got = RS.systematic_counts(w, uu)
        return dict(shape=list(w.shape), err=0.0,
                    ms=device_ms(lambda: RS.systematic_counts(w, uu), 30, kernel),
                    wall_ms=wall_ms(lambda: RS.systematic_counts(w, uu), 50),
                    plain_ms=wall_ms(lambda: RS.systematic_counts_reference(w, uu), 10),
                    bound=bound(nbytes(w, got), 0))

    w, r13 = k13(bank)
    w_nt, r13_nt = k13(bank[:, :UPD_NONTILING].contiguous())
    grid = "systematic_counts_grid_kernel"
    r14 = k14(w, u, grid)
    k14(w_deg, u, grid)
    r14_nt = k14(w_nt, u, grid)
    B, nf = UPD_FLEET
    wf = PK.gps_weights_call_reference(bank[:, :B * nf].contiguous(), gps, params).reshape(B, nf)
    wf = (wf / wf.sum(1, keepdim=True)).contiguous()
    uf = torch.rand(B, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    r14_fl = k14(wf, uf, "systematic_counts_flat_kernel")
    print(f"K13 at N={UPD_NONTILING} (no tiling): {r13_nt['ms'] * 1e3:.2f} us device, "
          f"{r13_nt['wall_ms']:.4f} ms a call back to back, plain {r13_nt['plain_ms']:.4f} ms; "
          f"K14 at N={UPD_NONTILING}: {r14_nt['ms'] * 1e3:.2f} us device, {r14_nt['wall_ms']:.4f} "
          f"ms a call, plain {r14_nt['plain_ms']:.4f} ms; K14 at {UPD_FLEET}: "
          f"{r14_fl['ms'] * 1e3:.2f} us device, {r14_fl['wall_ms']:.4f} ms a call, plain "
          f"{r14_fl['plain_ms']:.4f} ms; each bitwise its plain version (K14 also on degenerate "
          f"weights and at u = 0 and 1 - 2^-6)", flush=True)
    return {"K13": dict(r13, non_tiling=r13_nt), "K14": dict(r14, non_tiling=r14_nt, fleet=r14_fl)}


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


def timed_replays(fn, counters, T, what, n=5):
    """A main path's timed run: every launch count set to 0, n calls of fn()
    (each a graph replay) between CUDA events, the counts read after the
    first, which must have launched K1, K2 (phase 1) and K12 T times each.
    Returns (first result, counts, median ms, every ms, the first's host s)."""
    for f in counters:
        f.launches = 0
    first, ms0, wall = timed(fn)
    counts = {f.__name__: f.launches for f in counters}
    want = dict(da_lanes=T, sequential_update_fleet=T, symmetric_downdate=T)
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    reps = [ms0] + [timed(fn)[1] for _ in range(n - 1)]
    return first, counts, statistics.median(reps), reps, wall


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


def device_share(fn, kernels, replay_ms, what, top=0):
    """One more call of fn() (a replay) under torch.profiler: each kernel of
    ``kernels`` ({name fragment: launches}) with its mean device µs per
    launch and its share of the timed replay (µs × launches / replay time),
    then the device time of every kernel of the call together, as a share
    of the replay (the card's busy share), and the ``top`` kernels of the
    call by device time."""
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
                if names(e.key, k):
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
    evs = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    for e in evs[:top]:
        print(f"  {e.self_device_time_total / 1e3:.2f} ms device in {e.count} launches: "
              f"{e.key[:110]}", flush=True)
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
    from smarc_navigation_tpu_torch.ops import resampling as RS
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
                   PK.jitter_moments_call, PK.gps_weights_call, RS.systematic_counts]
    for f in pf_counters:
        f.launches = 0
    (fin_pf, out_pf), pf_ms, pf_wall = timed(lambda: PF.run(
        tl_pf, pf_params, pf_cfg, generator=torch.Generator(device=dev).manual_seed(0),
        scheme="systematic", use_pallas=True))
    pf_launch = {f.__name__: f.launches for f in pf_counters}
    if (pf_launch["predict_call_multi"] != n_seg or pf_launch["expand_gather_call"] != n_upd
            or pf_launch["gps_weights_call"] != n_upd or pf_launch["systematic_counts"] != n_upd):
        raise AssertionError(f"PF headline: launches {pf_launch}, expected K5 {n_seg} "
                             f"(segments), K7, K13 and K14 {n_upd} (GPS updates)")
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
    if (pt_launch["predict_call"] != T_pf
            or any(pt_launch[k] != n_upd
                   for k in ("expand_gather_call", "gps_weights_call", "systematic_counts"))):
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
            or any(cb_launch[k] != n_upd
                   for k in ("expand_gather_call", "gps_weights_call", "systematic_counts"))):
        raise AssertionError(f"combined: launches {cb_launch}, expected K1/K2/K12 {n_ev} "
                             f"(event ticks), K5 {n_seg}, K7, K13 and K14 {n_upd}")
    if not bool(torch.isfinite(val)):
        raise AssertionError("combined: non-finite result")
    print(f"combined mission (SLAM B=1 L={cfg.max_landmarks} M={cfg.max_obs}, {n_ev} event ticks of "
          f"{tls_np.ticks.shape[1]}; PF N={n}): {cb_ms:.1f} ms on the card "
          f"({cb_wall:.2f} s host), real-time factor {duration / (cb_ms / 1e3):.1f}x; "
          f"value {float(val):.4f}; launches {cb_launch}", flush=True)

    return pk, pf_launch, pt_launch, cb_launch


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
    """Phase 3b: K1 in both forms (pose rows, full Σ; MBES and FLS), K4 (and
    at M=16), K11, K2 at D=774 and K12 against their plain versions at
    L=256, B=32."""
    import torch

    from smarc_navigation_tpu_torch.io.workloads import slam_fleet_timelines
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2
    from smarc_navigation_tpu_torch.utils.geometry import odom_pose

    t0 = time.perf_counter()
    B, L, M = tl.ticks.shape[0], cfg.max_landmarks, cfg.max_obs
    D = 6 + 3 * L
    warm = tl.map(lambda x: x[:, :T_WARM])
    odom = tl.channels["odom"]
    pose_t = odom_pose(odom.value[:, T_WARM]).contiguous()
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
    res["K1_pose_rows"], got = k1_case("pose-rows form MBES", da_args, da_kw, zm, 3)
    want = K1.da_lanes_reference(*da_args, **da_kw)
    params_f = fls_params(S, cfg, dev)
    zf, zfm = fls_detections(S, ms_p.mu, ms_p.active, params_f, M, dev)
    zfm = zfm & valid_t[:, None]
    fls_args = base + (zf, zfm, torch.diagonal(params_f.Q_fls), params_f.lambda_fls,
                       cfg.outlier_cost, cfg.mhl_dist_fls, torch.tensor(S.FLS.new_lm_cov, device=dev))
    fls_kw = dict(sensor="fls", r_sb=params_f.r_fls_base, t_sb=params_f.t_fls_base,
                  band=ms_p.band, pose_rows=ms_p.rows)
    res["K1_pose_rows_fls"], gotf = k1_case("pose-rows form FLS", fls_args, fls_kw, zfm, 2)

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

    # --- K4 at EKFSlamConfig()'s max_obs=16: the same fleet replayed at M=16 --
    cfg16 = dataclasses.replace(cfg, max_obs=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl16 = slam_fleet_timelines(cfg16, 6.0, B).to(dev)
    odom16 = tl16.channels["odom"]
    pose16 = odom_pose(odom16.value[:, T_WARM]).contiguous()
    valid16 = odom16.valid[:, T_WARM].contiguous()
    ev16 = tl16.events["mbes"]
    z16 = ev16.value[:, T_WARM].contiguous()
    zm16 = (ev16.mask[:, T_WARM] & valid16[:, None]).contiguous()
    fm16, _ = S.run_fleet(tl16.map(lambda x: x[:, :T_WARM]), params, cfg16,
                          update_mode="marginal", graph=False)
    rows16 = torch.zeros(B, 8, D, device=dev)
    rows16[:, 0:6] = fm16.Sigma[:, 0:6]
    ms16 = S.MarginalFleetState(mu=fm16.mu, rows=rows16,
                                band=S.initial_band(fm16.Sigma, L).contiguous(),
                                active=fm16.active, n_active=fm16.n_active,
                                mu_auv_odom=fm16.mu_auv_odom)
    ms16_p, a816 = S._fleet_predict_marginal(ms16, pose16, valid16, params, predict_rows=False)
    args16 = (ms16_p.mu[:, 0:6].contiguous(), ms16_p.n_active, ms16_p.active,
              ms16_p.mu[:, 6:].reshape(B, L, 3).contiguous(), None, z16, zm16,
              torch.diagonal(params.Q_mbes), params.lambda_mbes, cfg.outlier_cost,
              cfg.mhl_dist_mbes, new_cov)
    kw16 = dict(sensor="mbes", A=a816[:, 0:6, 0:6].contiguous(),
                r_full=a816[:, 0:6, 8:14].contiguous(), band=ms16_p.band, pose_rows=ms16_p.rows)
    res["K1_pose_rows_M16"], got16 = k1_case("pose-rows form MBES", args16, kw16, zm16, 3)
    args4_16 = (ms16_p.rows, ms16_p.mu, *got16[1:4], (6 + 3 * got16[7]).contiguous(), got16[5],
                got16[6], new_cov, got16[4], ms16_p.band, a816)
    g4 = K2.sequential_update_marginal_fleet(*args4_16)
    torch.cuda.synchronize()
    err16 = marginal_err(g4, K2.sequential_update_marginal_fleet_reference(*args4_16), "K4 M=16")
    res["K4_M16"] = dict(err=err16, ms=device_ms(
        lambda: K2.sequential_update_marginal_fleet(*args4_16), 30, "marginal_kernel"),
        bound=bound(nbytes(*args4_16, *g4), k4_flops(B, D, 16, 3, True)))
    res["K4"]["err"] = max(res["K4"]["err"], err16)
    print(f"K4 M=16 (updates applied {int(got16[5].sum())} of {B * 16}): max err {err16:.3e}; "
          f"kernel {res['K4_M16']['ms']:.4f} ms device, bound {res['K4_M16']['bound'][0]:.5f} ms "
          f"({res['K4_M16']['bound'][1]})", flush=True)

    # --- K11 on the DA stage's own cost tables ----------------------------------
    cost = K1.da_tables_reference(*da_args, **da_kw)[0].contiguous()
    res["K11"] = k11_case(f"on the L={L} DA tables", cost, want[0])

    # --- the full carry: K2 at D=774, phase 1 + K12 ---------------------------
    st, _ = S.run_fleet(warm, params, cfg)
    band = S.initial_band(st.Sigma, L).contiguous()
    st_p, a8f = S._fleet_predict(st, pose_t, valid_t, params)
    da_full = (st_p.mu[:, 0:6].contiguous(), st_p.n_active, st_p.active,
               st_p.mu[:, 6:].reshape(B, L, 3).contiguous(), st_p.Sigma, z, zm,
               torch.diagonal(params.Q_mbes), params.lambda_mbes, cfg.outlier_cost,
               cfg.mhl_dist_mbes, new_cov)
    res["K1_full"], (ctr, H_sel, SinvH, nu_sel, cand, do, add, slot) = k1_case(
        "full form MBES", da_full, dict(sensor="mbes", A=a8f[:, 0:6, 0:6].contiguous(),
                                        r_full=a8f[:, 0:6, 8:14].contiguous(), band=band), zm, 3)
    zff, zffm = fls_detections(S, st_p.mu, st_p.active, params_f, M, dev)
    zffm = zffm & valid_t[:, None]
    res["K1_full_fls"], _ = k1_case("full form FLS", da_full[:5] + (zff, zffm) + fls_args[7:],
                                    dict(fls_kw, pose_rows=None, band=band), zffm, 2)
    k2_args = (st_p.Sigma, st_p.mu, H_sel, SinvH, nu_sel, (6 + 3 * slot).contiguous(), do, add,
               new_cov, cand, a8f, band)
    strm = K2.sequential_update_fleet(*k2_args)
    torch.cuda.synchronize()
    if not torch.equal(strm[0], strm[0].transpose(1, 2)):
        raise AssertionError(f"K2 at D={D}: Sigma not exactly symmetric")
    want2 = K2.sequential_update_fleet_reference(*k2_args)
    e2 = max(check(max_err(strm[0], want2[0]), "K2 D=774 Sigma"),
             check(max_err(strm[1], want2[1]), "K2 D=774 mu"),
             check(max_err(band_entries(strm[2]), band_entries(want2[2])), "K2 D=774 band"))
    _, _, P1, U, V, act = K2.phase1(*k2_args)
    res["K12"] = k12_phase(st_p.Sigma, U, V, P1, act, f"L={L}")
    phase1_ms = device_ms(lambda: K2.phase1(*k2_args), 30, "phase1_kernel")
    res["K2_774"] = dict(err=e2, ms=phase1_ms + res["K12"]["ms"], phase1_ms=phase1_ms,
                         bound=bound(nbytes(*k2_args, *strm), k2_flops(B, D, M, 3, True)))
    for k in ("K4",):
        v = res[k]
        print(f"{k}: max err {v['err']:.3e}; kernel {v['ms']:.4f} ms device ({v['wall_ms']:.4f} ms "
              f"per call back to back), plain {v['plain_ms']:.4f} ms, bound {v['bound'][0]:.4f} ms "
              f"({v['bound'][1]})", flush=True)
    v = res["K2_774"]
    print(f"K2 at D={D} B={B}: phase 1 {v['phase1_ms']:.4f} ms + K12 {res['K12']['ms']:.4f} ms "
          f"= {v['ms']:.4f} ms device (max err vs plain {v['err']:.3e}, bound "
          f"{v['bound'][0]:.4f} ms, {v['bound'][1]}); Sigma exactly symmetric "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


# phase 3c's shapes (L, M, sensor, Σ form): L + M = 1025 and 2048 rows, past
# the register JV; L = 1200, past the shared memory of the kernel before it;
# L = 900 at M = 64, whose tables alone do not fit
BIG_JV_CASES = ((1017, 8, "mbes", "rows"), (1017, 8, "fls", "full"), (2040, 8, "mbes", "full"),
                (2040, 8, "fls", "rows"), (1200, 8, "mbes", "full"), (900, 64, "mbes", "rows"))


def padded_da_case(S, ms_p, fm_sigma, a8, z, zm, params, cfg, Lp, Mp, sensor, form, dev):
    """K1's arguments for the fleet state ms_p (L slots) padded with
    inactive slots to Lp and with masked detections to Mp: pose rows (and
    the full Σ for ``form == "full"``), μ, band and the active flags grow
    with zeros; FLS takes pixel detections of the mapped landmarks."""
    import torch

    B, L = ms_p.active.shape
    D, Dp = 6 + 3 * L, 6 + 3 * Lp
    mu = torch.zeros(B, Dp, device=dev)
    mu[:, :D] = ms_p.mu
    rows = torch.zeros(B, 8, Dp, device=dev)
    rows[:, :, :D] = ms_p.rows
    band = torch.zeros(B, 24, Lp, device=dev)
    band[:, :, :L] = ms_p.band
    active = torch.zeros(B, Lp, dtype=torch.bool, device=dev)
    active[:, :L] = ms_p.active
    if sensor == "fls":
        params = fls_params(S, cfg, dev)
        z, zm = fls_detections(S, ms_p.mu, ms_p.active, params, z.shape[1], dev)
        spec, q = S.FLS, torch.diagonal(params.Q_fls)
        lam, mh = params.lambda_fls, cfg.mhl_dist_fls
    else:
        spec, q, lam, mh = S.MBES, torch.diagonal(params.Q_mbes), params.lambda_mbes, cfg.mhl_dist_mbes
    zp = torch.zeros(B, Mp, 3, device=dev)
    zp[:, :z.shape[1]] = z
    zmp = torch.zeros(B, Mp, dtype=torch.bool, device=dev)
    zmp[:, :z.shape[1]] = zm
    Sig = None
    if form == "full":
        Sig = torch.zeros(B, Dp, Dp, device=dev)
        Sig[:, :D, :D] = fm_sigma
    args = (mu[:, 0:6].contiguous(), ms_p.n_active, active, mu[:, 6:].reshape(B, Lp, 3).contiguous(),
            Sig, zp, zmp, q, lam, cfg.outlier_cost, mh, torch.tensor(spec.new_lm_cov, device=dev))
    kw = dict(sensor=sensor, A=a8[:, 0:6, 0:6].contiguous(), r_full=a8[:, 0:6, 8:14].contiguous(),
              band=band, pose_rows=rows if form == "rows" else None)
    if sensor == "fls":
        kw.update(r_sb=params.r_fls_base, t_sb=params.t_fls_base)
    return args, kw, zmp, spec.dim


def big_jv_phase(dev, cfg, params, tl):
    """Phase 3c: K1 (pose-rows and full-Σ forms, MBES and FLS) and K11 past
    the register JV (L + M > 1024 cost rows) and past the block's shared
    memory, on the L=256 fleet's state (B=4) padded with inactive slots,
    against their plain versions; on the unpadded state the scratch form
    against the register form, bit for bit."""
    import torch

    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1
    from smarc_navigation_tpu_torch.utils.geometry import odom_pose

    t0 = time.perf_counter()
    B, L, M = 4, cfg.max_landmarks, cfg.max_obs
    D = 6 + 3 * L
    sub = tl.map(lambda x: x[:B])
    fm, _ = S.run_fleet(sub.map(lambda x: x[:, :T_WARM]), params, cfg, update_mode="marginal",
                        graph=False)
    odom = sub.channels["odom"]
    pose_t = odom_pose(odom.value[:, T_WARM]).contiguous()
    valid_t = odom.valid[:, T_WARM].contiguous()
    rows = torch.zeros(B, 8, D, device=dev)
    rows[:, 0:6] = fm.Sigma[:, 0:6]
    ms = S.MarginalFleetState(mu=fm.mu, rows=rows, band=S.initial_band(fm.Sigma, L).contiguous(),
                              active=fm.active, n_active=fm.n_active, mu_auv_odom=fm.mu_auv_odom)
    ms_p, a8 = S._fleet_predict_marginal(ms, pose_t, valid_t, params, predict_rows=False)
    ev = sub.events["mbes"]
    z = ev.value[:, T_WARM].contiguous()
    zm = (ev.mask[:, T_WARM] & valid_t[:, None]).contiguous()

    def case(Lp, Mp, sensor, form):
        return padded_da_case(S, ms_p, fm.Sigma, a8, z, zm, params, cfg, Lp, Mp, sensor, form, dev)

    # where both forms run, the scratch form is the register form bit for bit
    n_bit = 0
    for sensor, form in (("mbes", "rows"), ("fls", "full")):
        args, kw, _, _ = case(L, M, sensor, form)
        reg = K1.da_lanes(*args, **kw)
        cost = K1.da_tables_reference(*args, **kw)[0].contiguous()
        reg11 = K1.hungarian_lanes(cost)
        K1.FORCE_SCRATCH = True
        try:
            scr = K1.da_lanes(*args, **kw)
            scr11 = K1.hungarian_lanes(cost)
        finally:
            K1.FORCE_SCRATCH = False
        torch.cuda.synchronize()
        if not (all(bitwise(a, b) for a, b in zip(reg, scr)) and torch.equal(reg11, scr11)):
            raise AssertionError(f"K1/K11 at L={L} ({sensor}, {form}): the scratch form differs "
                                 "from the register form")
        n_bit += 1
    res = {"K1": {}, "K11": {}}
    for Lp, Mp, sensor, form in BIG_JV_CASES:
        args, kw, zmp, dim = case(Lp, Mp, sensor, form)
        key = f"L{Lp}_M{Mp}_{sensor}_{form}"
        r, got = k1_case(f"past the register JV ({sensor}, {form})", args, kw, zmp, dim)
        res["K1"][key] = dict(ms=r["ms"], max_abs_err=r["err"], bound_ms=r["bound"][0],
                              bound_by=r["bound"][1], shape=list(r["shape"]))
        if sensor == "mbes":
            cost = K1.da_tables_reference(*args, **kw)[0].contiguous()
            r11 = k11_case(f"on the L={Lp} M={Mp} DA tables", cost, got[0])
            res["K11"][f"R{Lp + Mp}_C{Mp}"] = dict(ms=r11["ms"], max_abs_err=r11["err"],
                                                   bound_ms=r11["bound"][0],
                                                   bound_by=r11["bound"][1],
                                                   plain_ms=r11["plain_ms"])
    print(f"K1/K11 past the register JV: discrete outputs exact on {len(res['K1'])} K1 and "
          f"{len(res['K11'])} K11 shapes; scratch form == register form bitwise at L={L} "
          f"({n_bit} forms) ({time.perf_counter() - t0:.1f} s)", flush=True)
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


RC_B, RC_T = 1024, 301  # the raycast fleet of bench.py's raycast cell
DR_B = 256              # the SAM dead-reckoning fleet of bench.py's sam-dr cell
# SAM DR, card vs CPU: f32 cumsums of 6001 steps of ~2 cm at positions up to
# ~100 m, each add rounding to at most 7.6e-6 m, summed in another order
DR_TOL = 1e-2
# SLAM + PF fleet, card vs CPU, same seeds: the PF mean (the same uniforms bit
# for bit, normals a few ulps apart through the card's log, sin and cos; the
# weights an ulp apart can move a resample boundary by one particle of 1024)
FLEET_PF_TOL = 1e-2


def raycast_kernels_phase(dev):
    """Phase 16: K1 and K2 (phase 1 + K12) at the raycast fleet's shape
    (B=1024, L=32, M=8, D=102) on its state after T_WARM ticks, against their
    plain versions; device times and bounds."""
    import torch

    from smarc_navigation_tpu_torch.io.workloads import raycast_fleet_inputs
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import raycast
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2
    from smarc_navigation_tpu_torch.parallel import fleet as FL

    t0 = time.perf_counter()
    cfg, spec, gt, lms, lmm = raycast_fleet_inputs(RC_B, T_WARM + 1)
    gt, lms, lmm = (torch.as_tensor(x, device=dev) for x in (gt, lms, lmm))
    params = S.make_params(cfg, device=dev)
    B, L, M = RC_B, cfg.max_landmarks, cfg.max_obs
    D = 6 + 3 * L
    st, _ = FL.run_raycast_fleet(gt[:, :T_WARM], lms, lmm, cfg, params, spec, graph=False)
    pose = gt[:, T_WARM].contiguous()
    pts, zm = raycast.ping_detections(pose, lms, lmm, spec, M)
    st_p, _ = S._fleet_predict(st, pose, torch.ones(B, dtype=torch.bool, device=dev), params,
                               predict_sigma=True)
    band = S.initial_band(st_p.Sigma, L).contiguous()
    c = S.pass_consts(params, cfg, S.MBES)
    da_args = (st_p.mu[:, 0:6].contiguous(), st_p.n_active, st_p.active,
               st_p.mu[:, 6:].reshape(B, L, 3).contiguous(), st_p.Sigma, pts.contiguous(),
               zm.contiguous(), c.q_diag, c.lam, c.outlier, c.mh_dist, c.new_cov)
    k1, got = k1_case("raycast fleet MBES (band, no predict)", da_args, dict(sensor="mbes", band=band),
                      zm, 3)
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = got
    if not int(do.sum()) > 0:
        raise AssertionError("raycast kernels: no update to apply at the phase's tick")
    k2_args = (st_p.Sigma, st_p.mu, H_sel, SinvH, nu_sel, (6 + 3 * slot).contiguous(), do, add,
               c.new_cov, cand, None, band)
    strm = K2.sequential_update_fleet(*k2_args)
    torch.cuda.synchronize()
    if not torch.equal(strm[0], strm[0].transpose(1, 2)):
        raise AssertionError(f"K2 at B={B}: Sigma not exactly symmetric")
    want = K2.sequential_update_fleet_reference(*k2_args)
    e2 = max(check(max_err(strm[0], want[0]), f"K2 B={B} Sigma"),
             check(max_err(strm[1], want[1]), f"K2 B={B} mu"),
             check(max_err(band_entries(strm[2]), band_entries(want[2])), f"K2 B={B} band"))

    def k2():
        return K2.sequential_update_fleet(*k2_args)

    t = path_ms(k2, 30, ("phase1_kernel", "downdate_kernel"))
    _, _, P1, U, V, act = K2.phase1(*k2_args)
    k12 = k12_phase(st_p.Sigma, U, V, P1, act, f"raycast B={B} L={L}")
    res = dict(K1=k1, K12=k12, K2=dict(
        err=e2, ms=t["phase1_kernel"] + t["downdate_kernel"], phase1_ms=t["phase1_kernel"],
        downdate_ms=t["downdate_kernel"], wall_ms=wall_ms(k2, 50),
        plain_ms=wall_ms(lambda: K2.sequential_update_fleet_reference(*k2_args), 5),
        bound=bound(nbytes(*k2_args, *strm), k2_flops(B, D, M, 3, False)), shape=(B, L, M)))
    v = res["K2"]
    print(f"K2 at the raycast fleet's shape B={B} D={D} M={M} ({int(do.sum())} updates, "
          f"{int(add.sum())} adds): max err vs plain {e2:.3e}; phase 1 {v['phase1_ms']:.4f} + K12 "
          f"{v['downdate_ms']:.4f} = {v['ms']:.4f} ms device ({v['wall_ms']:.4f} ms per call back "
          f"to back), plain {v['plain_ms']:.3f} ms, bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def raycast_replay(dev, counters):
    """Phase 17: the raycast fleet ``raycast_fleet_inputs(1024, 301)``
    through ``run_raycast_fleet`` (the main path of this cell), graphed
    against eager (the second timeline: another rock field), then timed:
    K1, K2 (phase 1) and K12 once per tick; the kernels' shares."""
    import torch

    from smarc_navigation_tpu_torch.io.workloads import raycast_fleet_inputs
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.parallel import fleet as FL

    cfg, spec, gt, lms, lmm = raycast_fleet_inputs(RC_B, RC_T)
    gt, lms, lmm = (torch.as_tensor(x, device=dev) for x in (gt, lms, lmm))
    lms2 = torch.flip(lms, (0,)) + torch.tensor([1.5, -2.0, 0.0], device=dev)
    params = S.make_params(cfg, device=dev)
    B, T = RC_B, RC_T

    def run(graph, rocks=lms):
        return FL.run_raycast_fleet(gt, rocks, lmm, cfg, params, spec, use_da_kernel=True,
                                    graph=graph)

    g = graph_vs_eager(f"raycast fleet B={B} T={T}", run, lambda gr: run(gr, lms2), T)
    (final, (mu, na)), n, ms, reps, wall = timed_replays(lambda: run(True), counters, T,
                                                         "raycast fleet")
    for name, x in (("mu", mu), ("Sigma", final.Sigma)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"raycast fleet: non-finite {name}")
    n_act = na[:, -1].cpu()
    if not int((n_act > 0).sum()) >= B // 2:
        raise AssertionError(f"raycast fleet: too few missions mapped a rock: {n_act}")
    # the fleet's width changes nothing of a mission: its first 8 missions
    # replayed alone (eager; phase 18 holds that width against the CPU)
    _f8, (mu8, na8) = FL.run_raycast_fleet(gt[:8], lms[:8], lmm[:8], cfg, params, spec,
                                           use_da_kernel=True, graph=False)
    err = float((mu[:8] - mu8).abs().max())
    if not (torch.equal(na[:8], na8) and err <= POSE_TOL):
        raise AssertionError(f"raycast fleet: missions 0-7 differ from their B=8 replay "
                             f"(pose {err:.3e}, n_active equal {torch.equal(na[:8], na8)})")
    print(f"raycast fleet B={B} T={T} L={cfg.max_landmarks} M={cfg.max_obs} {spec.num_beams} beams "
          f"(graphed): {ms:.1f} ms on the card, the median of {len(reps)} replays ("
          + ", ".join(f"{r:.1f}" for r in reps) + f"; the first {wall:.2f} s host), "
          f"{ms * 1e3 / T:.1f} us/fleet tick, "
          f"{B * T / (ms / 1e3):.0f} steps/s; n_active min {int(n_act.min())} mean "
          f"{float(n_act.float().mean()):.2f} max {int(n_act.max())}; missions 0-7 against their "
          f"B=8 replay: n_active equal, max pose err {err:.3e}; launches {n}", flush=True)
    g["share"] = device_share(lambda: run(True), {"da_kernel": T, "phase1_kernel": T,
                                                  "downdate_kernel": T}, ms,
                              "raycast fleet (graphed)")
    g["ms"], g["replays_ms"] = ms, reps
    return n, g


def slice12_checks(dev):
    """Phase 18: card against CPU at small sizes: the raycast kernel path
    (B=8, T=40) and, on the card, its dense path against its kernel path;
    ``run_sam_dr_vectorized`` at B=256 (the 120 s mission), timed; the
    SLAM + PF fleet (8 missions, 40 ticks, both PF schemes) with the same
    seeds."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.io.workloads import (
        raycast_fleet_inputs, sam_dr_fleet_timelines, slam_fleet_timelines)
    from smarc_navigation_tpu_torch.models import dead_reckoning as DR
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.ops import resampling as RS
    from smarc_navigation_tpu_torch.parallel import fleet as FL

    t0 = time.perf_counter()
    cfg, spec, gt, lms, lmm = raycast_fleet_inputs(8, 40)
    runs = {}
    for name, d, kernel in (("card kernel", dev, None), ("card dense", dev, False),
                            ("CPU kernel", "cpu", True)):
        runs[name] = FL.run_raycast_fleet(
            *(torch.as_tensor(x, device=d) for x in (gt, lms, lmm)), cfg,
            S.make_params(cfg, device=d), spec, use_da_kernel=kernel)
    mu_k, na_k = (x.cpu() for x in runs["card kernel"][1])
    for other in ("card dense", "CPU kernel"):
        mu_o, na_o = (x.cpu() for x in runs[other][1])
        if not torch.equal(na_k, na_o):
            raise AssertionError(f"raycast B=8: n_active differs between the card kernel path and {other}")
        err = float((mu_k - mu_o).abs().max())
        if not err <= POSE_TOL:
            raise AssertionError(f"raycast B=8: pose differs from {other} by {err:.3e}")
        print(f"raycast fleet B=8 T=40: card kernel path vs {other}: n_active equal "
              f"(final {na_k[:, -1].tolist()}), max pose err {err:.3e}", flush=True)

    # the SAM DR fleet: closed form, card vs CPU, timed on the card
    res = {}
    tls = {k: sam_dr_fleet_timelines(dur, DR_B) for k, dur in (("s", 15.0), ("b", 120.0))}
    out_c = DR.run_sam_dr_vectorized(tls["b"].to("cpu"))
    tl_b = tls["b"].to(dev)
    out_g = DR.run_sam_dr_vectorized(tl_b)
    err = float((out_g.cpu() - out_c).abs().max())
    if not err <= DR_TOL:
        raise AssertionError(f"SAM DR B={DR_B}: card vs CPU max err {err:.3e} > {DR_TOL}")
    on_card = {k: tl.to(dev) for k, tl in tls.items()}
    ms = {k: statistics.median([timed(lambda: DR.run_sam_dr_vectorized(tl))[1] for _ in range(5)])
          for k, tl in on_card.items()}
    Ts = {k: tl.ticks.shape[1] for k, tl in tls.items()}
    slope = (ms["b"] - ms["s"]) / (Ts["b"] - Ts["s"])
    res["dr"] = dict(us_per_tick=ms["b"] * 1e3 / Ts["b"], slope_us=slope * 1e3, err=err,
                     device_ms=call_device_ms(lambda: DR.run_sam_dr_vectorized(tl_b), 10))
    print(f"SAM DR fleet B={DR_B} (closed form): card vs CPU max err {err:.3e} (T={Ts['b']}); "
          f"{ms['b']:.3f} ms per {Ts['b']}-tick replay = {res['dr']['us_per_tick']:.3f} us/fleet "
          f"tick ({DR_B / (res['dr']['us_per_tick'] / 1e6):.4g} ticks/s), slope over the "
          f"{Ts['s']}- and {Ts['b']}-tick replays {res['dr']['slope_us']:.3f} us/fleet tick; device "
          f"time of one replay {res['dr']['device_ms']:.3f} ms", flush=True)

    # the SLAM + PF fleet, card vs CPU, the same seeds
    scfg = dataclasses.replace(cfg, max_landmarks=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ftl = slam_fleet_timelines(scfg, 3.9, 8)
    pcfg = PFConfig(particle_count=1024)
    res["fleet_k14"] = {}
    for scheme in ("residual", "systematic"):
        outs = {}
        for d in (dev, "cpu"):
            RS.systematic_counts.launches = 0
            outs[str(d)] = FL.run_fleet(ftl.to(d), scfg, S.make_params(scfg, device=d), pcfg,
                                        PF.make_params(pcfg, device=d), 1024, seed=3,
                                        pf_scheme=scheme, graph=False)[1]
            if d == dev:
                res["fleet_k14"][scheme] = RS.systematic_counts.launches
        (og, oc) = (outs[str(dev)], outs["cpu"])
        # the systematic scheme's (8, 1024) banks take K14 once a tick
        want = og["pf"]["mean"].shape[0] if scheme == "systematic" else 0
        if res["fleet_k14"][scheme] != want:
            raise AssertionError(f"SLAM+PF fleet ({scheme}): {res['fleet_k14'][scheme]} K14 "
                                 f"launches, expected {want}")
        for key in ("matched_mbes", "n_active"):
            if not torch.equal(og["slam"][key].cpu(), oc["slam"][key]):
                raise AssertionError(f"SLAM+PF fleet ({scheme}): slam {key} differs card vs CPU")
        if not torch.equal(og["pf"]["updated"].cpu(), oc["pf"]["updated"]):
            raise AssertionError(f"SLAM+PF fleet ({scheme}): pf updated differs card vs CPU")
        e_s = float((og["slam"]["mu"].cpu() - oc["slam"]["mu"]).abs().max())
        e_p = float((og["pf"]["mean"].cpu() - oc["pf"]["mean"]).abs().max())
        if not (e_s <= POSE_TOL and e_p <= FLEET_PF_TOL):
            raise AssertionError(f"SLAM+PF fleet ({scheme}): card vs CPU slam mu {e_s:.3e}, "
                                 f"pf mean {e_p:.3e}")
        print(f"SLAM+PF fleet B=8 T={og['pf']['mean'].shape[0]} N=1024 ({scheme}): card vs CPU "
              f"(seed 3): associations, n_active and updates equal, max slam pose err {e_s:.3e}, "
              f"max pf mean err {e_p:.3e} ({int(og['pf']['updated'].sum())} GPS updates); K14 "
              f"launches {res['fleet_k14'][scheme]}", flush=True)
    print(f"slice-12 checks: {time.perf_counter() - t0:.1f} s", flush=True)
    return res


SPF_T, SPF_N = 101, 1024  # the SLAM + PF fleet: the headline's first 10 s, particles a mission


def slam_pf_replay(dev, cfg, params, tl, counters):
    """Phase 19: the SLAM + PF mission fleet ``fleet.run_fleet`` at the
    headline's width (B=128, L=64, M=8) over its first 10 s (T=101), 1024
    particles a mission, the default residual resampler: graphed against
    eager (the second timeline: the missions rotated by one), then timed:
    K1, K2 (phase 1) and K12 once per tick; the kernels' shares."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.parallel import fleet as FL

    tl = tl.map(lambda x: x[:, :SPF_T])
    tl2 = tl.map(lambda x: torch.roll(x, 1, 0))
    B, T = tl.ticks.shape
    pcfg = PFConfig(particle_count=SPF_N)
    pparams = PF.make_params(pcfg, device=dev)

    def run(graph, t=tl):
        return FL.run_fleet(t, cfg, params, pcfg, pparams, SPF_N, seed=4, graph=graph)

    what = f"SLAM+PF fleet B={B} T={T} N={SPF_N}"
    g = graph_vs_eager(what, run, lambda gr: run(gr, tl2), T)
    (final, out), n, ms, reps, wall = timed_replays(lambda: run(True), counters, T, what)
    for name, x in (("slam mu", out["slam"]["mu"]), ("pf mean", out["pf"]["mean"]),
                    ("particles", final.pf.particles), ("Sigma", final.slam.Sigma)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    n_act, n_upd = final.slam.n_active.cpu(), int(out["pf"]["updated"].sum())
    if not (int((n_act > 0).sum()) >= B // 2 and n_upd > 0):
        raise AssertionError(f"{what}: n_active {n_act.tolist()}, {n_upd} GPS updates")
    gap = (out["pf"]["mean"][-1, :, 0:2] - out["slam"]["mu"][-1, :, 0:2]).norm(dim=1)
    print(f"{what} (graphed): {ms:.1f} ms on the card, the median of {len(reps)} replays ("
          + ", ".join(f"{r:.1f}" for r in reps) + f"; the first {wall:.2f} s host), "
          f"{ms * 1e3 / T:.1f} us/fleet tick, {B * T / (ms / 1e3):.0f} mission ticks/s; "
          f"{n_upd} GPS updates; n_active mean {float(n_act.float().mean()):.1f}; PF mean to "
          f"SLAM pose at the last tick: median {float(gap.median()):.3f} m, max "
          f"{float(gap.max()):.3f} m; launches {n}", flush=True)
    g["share"] = device_share(lambda: run(True), {"da_kernel": T, "phase1_kernel": T,
                                                  "downdate_kernel": T}, ms, f"{what} (graphed)",
                              top=12)
    g["ms"], g["replays_ms"] = ms, reps
    return n, g


CLI_CPU_S = 30.0   # phase 20: the CPU side of each card-vs-CPU CLI check (the card runs whole)
CHUNK = 128        # phase 20e: ticks per chunk of the chunked SLAM replay
# phase 20d: the pf mission's GPS fixes (std 0.3 m, 1 Hz, the vehicle never
# dives below the GPS cutoff) hold the bank to within a few fix sigmas: 1 m
# is ~3 sigma of a single fix, far below a lost filter's growing error
PF_CLI_ERR_M = 1.0
SAMPLE_LOG = "data/sample_mission.npz"


def quiet(fn, *args):
    """fn(*args) with its standard output (a CLI's printed report) kept
    out of this script's."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def cut_log(path, seconds):
    """The sample log's first ``seconds`` written as a log of its own."""
    from smarc_navigation_tpu_torch.io import logs

    streams, meta = logs.load_log(SAMPLE_LOG)
    base = min(s["stamps"][0] for s in streams.values() if len(s["stamps"]))
    logs.save_log(path, {n: {k: v[s["stamps"] < base + seconds + 1e-9] for k, v in s.items()}
                         for n, s in streams.items()}, meta=meta)
    return path


def close_reports(card, cpu, keys, what):
    for k in keys:
        if not abs(card[k] - cpu[k]) <= POSE_TOL:
            raise AssertionError(f"{what}: {k} {card[k]:.6f} on the card, {cpu[k]:.6f} on the CPU")


def cli_phase(dev):
    """Phase 20: the mission CLI on the card (see the module docstring).
    Returns {path: launches} of K1, K2, K3, K12, K5, K7, K13, K14 and K15."""
    import os
    import shutil
    import tempfile

    import torch

    from smarc_navigation_tpu_torch import native, run
    from smarc_navigation_tpu_torch.configs import EKFSlamConfig
    from smarc_navigation_tpu_torch.io import logs, observability, replay, sim
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.ops import assignment
    from smarc_navigation_tpu_torch.ops import pf_kernels as PK
    from smarc_navigation_tpu_torch.ops import resampling as RS
    from smarc_navigation_tpu_torch.ops import slam_da_kernels as K1
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    counters = [K1.da_lanes, K2.sequential_update_fleet, K2.sequential_update,
                K2.symmetric_downdate, PK.predict_call_multi, PK.expand_gather_call,
                PK.gps_weights_call, RS.systematic_counts, K2.online_predict]

    def reset():
        for f in counters:
            f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in counters}

    # --- 20a. the native JV and binner ---------------------------------------
    if not native.available():
        raise AssertionError("native: the host library did not build (g++)")
    rng = np.random.default_rng(0)
    for _ in range(50):
        R, C = int(rng.integers(8, 80)), int(rng.integers(1, 9))
        cost = rng.uniform(0, 10, (R + C, C))
        a, b = native.jv_assign(cost), assignment._scipy_solve(cost)
        ca, cb = cost[a, np.arange(C)].sum(), cost[b, np.arange(C)].sum()
        if not abs(ca - cb) <= 1e-9 * max(1.0, abs(cb)):
            raise AssertionError(f"native JV: cost {ca} against scipy's optimum {cb}")
    n_scipy_differs = 0
    for _ in range(50):
        L, M = int(rng.integers(3, 65)), int(rng.integers(1, 9))
        cost = rng.integers(0, 4, (L + M, M)).astype(np.float32)   # exact ties
        cost[L:] = 10000.0
        cost[L + np.arange(M), np.arange(M)] = 2.0
        got = native.jv_assign(cost)
        if not np.array_equal(got, assignment.hungarian(torch.from_numpy(cost)).numpy()):
            raise AssertionError("native JV: tied table assigned unlike assignment.hungarian")
        n_scipy_differs += not np.array_equal(got, assignment._scipy_solve(cost))
    streams, _meta = logs.load_log(SAMPLE_LOG)
    cfg = dataclasses.replace(EKFSlamConfig(), max_landmarks=64, max_obs=8, mhl_dist_mbes=1.0,
                              q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)   # run.py replay's

    def log_timeline():
        return logs.log_to_timeline(streams, freq_hz=cfg.system_freq, channels=("odom",),
                                    events={"mbes": cfg.max_obs})

    tl_np = log_timeline()
    bin_events = native.bin_events
    native.bin_events = lambda *a: None        # the Python binner
    try:
        tl_py = log_timeline()
    finally:
        native.bin_events = bin_events
    for f in ("value", "mask"):
        if not bitwise(torch.from_numpy(getattr(tl_np.events["mbes"], f)),
                       torch.from_numpy(getattr(tl_py.events["mbes"], f))):
            raise AssertionError(f"native binner: mbes {f} differs from the Python binner's")
    n_det = int(tl_np.events["mbes"].mask.sum())
    print(f"20a native: JV at scipy's optimum on 50 random tables, equal to "
          f"assignment.hungarian on 50 tied tables ({n_scipy_differs} where scipy breaks a tie "
          f"another way); binner bitwise the Python loop on the sample log's {n_det} MBES "
          f"detections", flush=True)

    # --- 20b. run.py replay on the sample log ------------------------------------
    T = tl_np.num_ticks
    burst = tl_np.events["mbes"].mask.any(-1)
    n_burst = int(burst.sum())
    launches = {}
    reset()
    rep = quiet(run.main, ["replay", "--log", SAMPLE_LOG, "--out", os.path.join(tmp, "replay")])
    launches["cli-replay"] = counts()
    if ([launches["cli-replay"][k] for k in ("da_lanes", "sequential_update_fleet",
                                             "symmetric_downdate", "sequential_update",
                                             "online_predict")]
            != [n_burst, n_burst, n_burst, 0, T]):
        raise AssertionError(f"cli replay: launches {launches['cli-replay']}, expected K1, K2 "
                             f"and K12 {n_burst} (the log's ticks with an MBES burst), K3 none, "
                             f"K15 {T} (every tick)")
    if rep["ticks"] != T or not np.isfinite(rep["rmse_pos"]):
        raise AssertionError(f"cli replay: report {rep}")
    # card against CPU: the card's ekf_slam.run over the whole log (also
    # 20e's yardstick); the CPU's CLI and ekf_slam.run over its first 30 s,
    # held against the card run's first ticks (the replay is causal) and
    # the report the CLI makes of them
    n_cpu = int(round(CLI_CPU_S * cfg.system_freq)) + 1
    params = S.make_params(cfg, device=dev)
    tl = tl_np.to(dev)
    run_final, run_out = S.run(tl, params, cfg)
    cut = cut_log(os.path.join(tmp, "cut.npz"), CLI_CPU_S)
    rep_p = quiet(run.main, ["replay", "--log", cut, "--out", os.path.join(tmp, "rp"),
                             "--device", "cpu"])
    gt_s = streams["gt"]["stamps"] - min(s["stamps"][0] for s in streams.values())
    ticks = np.asarray(tl_np.ticks[:n_cpu], np.float64)
    gt = streams["gt"]["values"][np.clip(np.searchsorted(gt_s, ticks, side="right") - 1, 0,
                                         len(gt_s) - 1)][:, :6]
    rep_c = observability.run_report(run_out["mu"][:n_cpu], gt, device=dev)
    rep_c["n_landmarks_mapped"] = int(run_out["n_active"][n_cpu - 1])
    if rep_c["n_landmarks_mapped"] != rep_p["n_landmarks_mapped"] or rep_p["ticks"] != n_cpu:
        raise AssertionError(f"cli replay {CLI_CPU_S:g} s: {rep_c['n_landmarks_mapped']} "
                             f"landmarks on the card, {rep_p['n_landmarks_mapped']} on the CPU")
    close_reports(rep_c, rep_p, ("final_error", "mean_error", "rmse_pos", "max_error"),
                  f"cli replay {CLI_CPU_S:g} s")
    cpu_final, cpu_out = S.run(tl_np.map(lambda x: x[:n_cpu]).to("cpu"),
                               S.make_params(cfg, device="cpu"), cfg)
    if not torch.equal(run_out["matched_mbes"][:n_cpu].cpu(), cpu_out["matched_mbes"]):
        raise AssertionError("ekf_slam.run on the log: matched_mbes differs card vs CPU")
    pose_err = float((run_out["mu"][:n_cpu].cpu() - cpu_out["mu"]).abs().max())
    if not pose_err <= POSE_TOL:
        raise AssertionError(f"ekf_slam.run on the log: poses differ by {pose_err:.3e}")
    print(f"20b cli replay {SAMPLE_LOG} (T={T}, L={cfg.max_landmarks}, M={cfg.max_obs}): wall_s "
          f"{rep['wall_s']}, realtime_factor {rep['realtime_factor']}, "
          f"{rep['n_landmarks_mapped']} landmarks, rmse_pos {rep['rmse_pos']:.4f} m; K1, K2 and K12 "
          f"once per burst tick ({n_burst}); first {CLI_CPU_S:g} s card vs CPU: "
          f"{rep_c['n_landmarks_mapped']} landmarks both, final_error {rep_c['final_error']:.6f} "
          f"/ {rep_p['final_error']:.6f}; ekf_slam.run matched_mbes equal, max pose err "
          f"{pose_err:.3e}", flush=True)

    # --- 20c. run.py demo ------------------------------------------------------------
    reset()
    demo = quiet(run.main, ["demo", "--duration", "60", "--out", os.path.join(tmp, "demo")])
    launches["cli-demo"] = counts()
    if launches["cli-demo"]["da_lanes"] < 1 or launches["cli-demo"]["sequential_update_fleet"] < 1:
        raise AssertionError(f"cli demo: K1 and K2 were not launched: {launches['cli-demo']}")
    d_c = quiet(run.main, ["demo", "--duration", f"{CLI_CPU_S:g}", "--out",
                           os.path.join(tmp, "dc")])
    d_p = quiet(run.main, ["demo", "--duration", f"{CLI_CPU_S:g}", "--out",
                           os.path.join(tmp, "dp"), "--device", "cpu"])
    if d_c["report"]["n_landmarks_mapped"] != d_p["report"]["n_landmarks_mapped"]:
        raise AssertionError("cli demo: n_landmarks_mapped differs card vs CPU")
    for name in d_c["stats"]:
        close_reports(d_c["stats"][name], d_p["stats"][name], ("final_error", "mean_error"),
                      f"cli demo {CLI_CPU_S:g} s {name}")
    close_reports(d_c["report"], d_p["report"], ("final_error", "mean_error"),
                  f"cli demo {CLI_CPU_S:g} s report")
    r = demo["report"]
    print(f"20c cli demo 60 s: dr_wall_s {r['dr_wall_s']:.6f}, slam_wall_s {r['slam_wall_s']:.4f}, "
          f"slam_realtime_factor {r['slam_realtime_factor']:.3f}, {r['n_landmarks_mapped']} "
          f"landmarks, mean_error {r['mean_error']:.4f} m; launches {launches['cli-demo']}; "
          f"{CLI_CPU_S:g} s card vs CPU: {d_c['report']['n_landmarks_mapped']} landmarks both, "
          f"final_error {d_c['report']['final_error']:.6f} / {d_p['report']['final_error']:.6f}",
          flush=True)

    # --- 20d. run.py pf --pallas at 2^20 particles ---------------------------------
    m = sim.simulate(sim.MissionSpec(duration_s=60.0, gps_surface_z=-100.0, gps_std=0.3,
                                     dvl_std=0.02, seed=0))    # run.py pf's mission
    tlp = PF.pf_timeline(m)
    upd = tlp.channels["gps"].fresh & (tlp.channels["diving"].value[:, 0] < 0.5)
    n_upd, n_seg = int(upd.sum()), len(PF._segment_plan(upd, 12))
    reset()
    pf = quiet(run.main, ["pf", "--particles", str(PF_N), "--pallas"])
    launches["cli-pf"] = counts()
    # the CLI replays twice (its warm-up, then the timed replay)
    if (launches["cli-pf"]["predict_call_multi"] != 2 * n_seg
            or any(launches["cli-pf"][k] != 2 * n_upd
                   for k in ("expand_gather_call", "gps_weights_call", "systematic_counts"))):
        raise AssertionError(f"cli pf: launches {launches['cli-pf']}, expected K5 2 x {n_seg} "
                             f"(segments), K7, K13 and K14 2 x {n_upd} (GPS updates)")
    if not (np.isfinite(pf["xy_err_mean_m"]) and pf["xy_err_mean_m"] < PF_CLI_ERR_M):
        raise AssertionError(f"cli pf: xy_err_mean_m {pf['xy_err_mean_m']} >= {PF_CLI_ERR_M}")
    dense = quiet(run.main, ["pf", "--particles", str(PF_N)])
    print(f"20d cli pf --particles {PF_N} --pallas (T={pf['ticks']}, {n_seg} segments, {n_upd} "
          f"GPS updates): particle_updates_per_sec {pf['particle_updates_per_sec']}, "
          f"realtime_factor {pf['realtime_factor']}, wall_s {pf['wall_s']}, xy_err_mean_m "
          f"{pf['xy_err_mean_m']} (bound {PF_CLI_ERR_M}); the dense path (residual) at the same "
          f"N: xy_err_mean_m {dense['xy_err_mean_m']}, wall_s {dense['wall_s']}, "
          f"particle_updates_per_sec {dense['particle_updates_per_sec']}; K5, K7, K13 and K14 "
          f"{launches['cli-pf']}", flush=True)

    # --- 20e. the chunked SLAM replay --------------------------------------------------
    def step(state, tick):
        return S.step(cfg, params, state, tick)

    ck = os.path.join(tmp, "ck")
    reset()
    (fin, out), ch_ms, _w = timed(lambda: replay.run_chunked(
        step, S.init_state(cfg, device=dev), tl, chunk_size=CHUNK, ckpt_dir=ck,
        ckpt_every_chunks=1))
    launches["chunked-replay"] = counts()
    if (launches["chunked-replay"]["da_lanes"] != n_burst
            or launches["chunked-replay"]["sequential_update_fleet"] != n_burst):
        raise AssertionError(f"chunked replay: launches {launches['chunked-replay']}")
    assert_bitwise(fin, run_final, "chunked replay final state")
    assert_bitwise({k: torch.from_numpy(v) for k, v in out.items()},
                   {k: v.cpu() for k, v in run_out.items()}, "chunked replay outputs")
    mid_tick = CHUNK * (-(-T // CHUNK) - 2)     # the last checkpoint but one
    mid = os.path.join(tmp, "mid")
    os.makedirs(mid)
    shutil.copy(os.path.join(ck, f"ckpt_{mid_tick}.npz"), mid)
    fin2, tail = replay.run_chunked(step, S.init_state(cfg, device=dev), tl,
                                    chunk_size=CHUNK, ckpt_dir=mid)
    assert_bitwise(fin2, run_final, "resumed replay final state")
    assert_bitwise({k: torch.from_numpy(v) for k, v in tail.items()},
                   {k: v[mid_tick:].cpu() for k, v in run_out.items()}, "resumed replay tail")

    def nan_step(state, tick):
        state, o = step(state, tick)
        return state._replace(mu=state.mu * float("nan")), o

    try:
        replay.run_chunked(nan_step, S.init_state(cfg, device=dev), tl.map(lambda x: x[:16]),
                           chunk_size=8)
        raise AssertionError("chunked replay: a NaN state raised no ReplayError")
    except replay.ReplayError as e:
        nan_msg = str(e)
    first = int(np.flatnonzero(burst)[0])
    short = tl.map(lambda x: x[:first + 8])
    trace_dir = os.path.join(tmp, "trace")
    replay.profile_replay(step, S.init_state(cfg, device=dev), short, trace_dir)
    with open(os.path.join(trace_dir, "replay_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    traced = {k: sum(1 for e in events if names(e.get("name", ""), k))
              for k in ("da_kernel", "phase1_kernel", "downdate_kernel")}
    if not all(traced.values()):
        raise AssertionError(f"profile_replay: the trace lacks a K1 or K2 kernel: {traced}")
    print(f"20e chunked replay (chunk {CHUNK}, a checkpoint per chunk): {ch_ms:.1f} ms, final "
          f"state and outputs bitwise ekf_slam.run on the card; resumed from ckpt_{mid_tick}: "
          f"the tail bitwise; NaN guard: {nan_msg!r}; profile_replay trace of {first + 8} ticks: "
          f"{traced}", flush=True)
    shutil.rmtree(tmp)
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


MESH_P = 4          # phase 21: shards of each mesh, all on the one card
MESH_H = 4096       # the distributed resample's halo (its default)
MESH_RC_T = 76      # phase 21: ticks of the mission-sharded raycast fleet (bench.py's short T)
MESH_SPF_T = 51     # phase 21: ticks of the (mission, particle)-sharded SLAM + PF fleet


def window_case(m_cum, bank, s, ns, H):
    """Shard s's halo-extended window of global counts and bank columns, as
    ``resample_dist.systematic_gather_shard`` builds it: H columns from each
    neighbour, zeros off the left edge, counts n off the right one."""
    import torch

    n = m_cum.shape[0]
    lo, hi = s * ns, (s + 1) * ns
    m_left = m_cum[lo - H:lo] if s else torch.zeros(H, dtype=m_cum.dtype, device=m_cum.device)
    m_right = m_cum[hi:hi + H] if hi < n else torch.full((H,), n, dtype=m_cum.dtype,
                                                        device=m_cum.device)
    p_left = bank[:, lo - H:lo] if s else torch.zeros_like(bank[:, :H])
    p_right = bank[:, hi:hi + H] if hi < n else torch.zeros_like(bank[:, :H])
    return (torch.cat([m_left, m_cum[lo:hi], m_right]).contiguous(),
            torch.cat([p_left, bank[:, lo:hi], p_right], 1).contiguous())


def mesh_kernels_phase(dev, tl_pf):
    """Phase 21a: K7's window form against its plain version at a shard's
    shape (n_out = 2^18, n_in = 2^18 + 2·4096) on healthy, degenerate and
    zero-run counts of a 2^20 bank, for a left-edge, an interior and a
    right-edge shard, exactly, and against the whole-bank K7's slice; the
    whole-bank K7 bitwise the window form at out_off 0; K5 and K6 at 2^18
    with idx_off = s·2^18: four shards side by side bitwise the 2^20 call.
    Times the window form and K8 at the shard's shape."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.ops import pf_kernels as PK
    from smarc_navigation_tpu_torch.ops import resampling as RS

    n, P_, H = PF_N, MESH_P, MESH_H
    ns = n // P_
    params = PF.make_params(PFConfig(particle_count=n), device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    bank = PF.init_state(n, params, gen).particles
    pre = PF._tick_precompute(tl_pf, params, gen)
    nxy, nyaw = PF._noise_flags(params)
    t_up = int(pre.do_update.nonzero()[0])
    gps, u = pre.gps_xy[t_up], pre.res_u[t_up]
    weights = {"healthy": RS.normalize_weights_det(PK.fast_logw(bank, gps, params))}
    weights["degenerate"] = torch.zeros(n, device=dev)
    weights["degenerate"][777] = 1.0
    zr = torch.zeros(n, device=dev)
    zr[:64] = zr[-64:] = 1.0 / 128
    weights["zero-run"] = zr
    checked = 0
    for name, w in weights.items():
        m_cum = RS.systematic_counts(w, u)
        whole = PK.expand_gather_call(m_cum, bank)
        if not bitwise(PK.expand_gather_window_call(m_cum, bank, 0, n), whole):
            raise AssertionError(f"K7 ({name}): the whole bank differs from the window form at 0")
        for s in (0, 1, P_ - 1):
            m_ext, p_ext = window_case(m_cum, bank, s, ns, H)
            got = PK.expand_gather_window_call(m_ext, p_ext, s * ns, ns)
            torch.cuda.synchronize()
            want = PK.expand_gather_window_call_reference(m_ext, p_ext, s * ns, ns)
            if not torch.equal(got, want):
                raise AssertionError(f"K7 window ({name}, shard {s}): differs from the plain version")
            if name == "healthy" and not torch.equal(got, whole[:, s * ns:(s + 1) * ns]):
                raise AssertionError(f"K7 window (shard {s}): not the whole-bank K7's columns")
            checked += 1
        if name == "healthy":
            m_h = m_cum
    # the timed case: an interior shard on healthy weights
    m_ext, p_ext = window_case(m_h, bank, 1, ns, H)

    def k7w():
        return PK.expand_gather_window_call(m_ext, p_ext, ns, ns)

    t7 = path_ms(k7w, 30, ("gather_kernel", "FillFunctor"))
    win = dict(err=0.0, ms=sum(t7.values()), kernel_ms=t7["gather_kernel"], wall_ms=wall_ms(k7w, 50),
               plain_ms=wall_ms(lambda: PK.expand_gather_window_call_reference(
                   m_ext, p_ext, ns, ns), 10),
               bound=bound(nbytes(m_ext, p_ext, k7w()), 0), shape=[6, int(m_ext.shape[0]), ns])
    # K5 / K6 with the particle offset: shards side by side are the whole call
    par16, seeds = pre.par16[0:10].contiguous(), pre.seeds[0:10].contiguous()
    for what, call in (
            ("K5", lambda p, off: PK.predict_call_multi(p, par16, seeds, nxy, nyaw, idx_off=off)),
            ("K6", lambda p, off: PK.predict_call(p, par16[0], seeds[0], nxy, nyaw, idx_off=off))):
        full = call(bank, 0)
        parts = [call(bank[:, s * ns:(s + 1) * ns].contiguous(), s * ns) for s in range(P_)]
        torch.cuda.synchronize()
        if not (bitwise(torch.cat([p[0] for p in parts], 1), full[0])
                and bitwise(torch.cat([p[1] for p in parts], -1), full[1])):
            raise AssertionError(f"{what}: {P_} shards with idx_off differ from the 2^20 call")
    # K8 at a shard's shape with its seed offset
    shard = PK.expand_gather_call(m_h, bank)[:, ns:2 * ns].contiguous()
    sd = torch.sqrt(params.res_noise_cov)
    jsd = torch.stack([sd[0], sd[1], sd[5]]).contiguous()
    seed = pre.noise_seeds[t_up]

    def k8():
        return PK.jitter_moments_call(shard, jsd, seed, seed_off=ns)

    got8 = k8()
    r8 = PK.jitter_moments_call_reference(shard, jsd, seed, seed_off=ns)
    e8 = max(check(bank_err(got8[0], r8[0]), "K8 at a shard"), check(max_err(got8[1], r8[1]),
                                                                       "K8 sums at a shard"))
    k8s = dict(err=e8, ms=device_ms(k8, 30, "jitter_kernel"), shape=[6, ns],
               bound=bound(nbytes(shard, jsd, *got8), ns * PF_JITTER_FLOPS,
                           pf_int_ops(ns, True, True)))
    print(f"phase 21a: K7 window form n_out={ns} n_in={win['shape'][1]}: {checked} cases "
          f"(healthy, degenerate, zero-run x left, interior, right shard) equal to the plain "
          f"version; whole-bank K7 == window form at out_off 0; {win['ms'] * 1e3:.2f} us device "
          f"per call (kernel {win['kernel_ms'] * 1e3:.2f}), plain {win['plain_ms']:.4f} ms, bound "
          f"{win['bound'][0] * 1e3:.2f} us ({win['bound'][1]}); K5 and K6 with idx_off: "
          f"{P_} shards == the {n} call bitwise; K8 at a shard {k8s['ms'] * 1e3:.2f} us (bound "
          f"{k8s['bound'][0] * 1e3:.2f} us), max err {e8:.3e}", flush=True)
    return win, k8s


def mesh_pf_phase(dev, tl_pf):
    """Phase 21b: ``run_fast_segmented`` with ``pmesh=make_mesh(particle=4,
    devices=[cuda] * 4)`` on pf-1M-60s (N = 2^20), bitwise the unsharded
    replay (bank, mean, cov), K5 / K7's window form / K8 4 x segments /
    updates / updates times; both timed (median of three, CUDA events);
    one forced exact-branch resample (a degenerate weight vector) bitwise
    the unsharded gather."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.ops import pf_kernels as PK
    from smarc_navigation_tpu_torch.ops import resampling as RS
    from smarc_navigation_tpu_torch.parallel import mesh, resample_dist

    n, P_ = PF_N, MESH_P
    cfg = PFConfig(particle_count=n)
    params = PF.make_params(cfg, device=dev)
    pm = mesh.make_mesh(particle=P_, devices=[dev] * P_)
    upd = (tl_pf.channels["gps"].fresh & (tl_pf.channels["diving"].value[:, 0] < 0.5)).cpu().numpy()
    n_upd, n_seg = int(upd.sum()), len(PF._segment_plan(upd, 12))

    def run(pmesh):
        return PF.run_fast_segmented(tl_pf, params, cfg, generator=torch.Generator(
            device=dev).manual_seed(0), pmesh=pmesh)

    run(pm)                                                      # warm-up
    run(None)
    counters = [PK.predict_call_multi, PK.expand_gather_window_call, PK.jitter_moments_call,
                PK.expand_gather_call, PK.gps_weights_call, RS.systematic_counts]
    for f in counters:
        f.launches = 0
    resample_dist.exact_fallbacks = 0
    (fin1, out1), ms1, wall1 = timed(lambda: run(pm))
    launches = {f.__name__: f.launches for f in counters}
    fallbacks = resample_dist.exact_fallbacks
    want = dict(predict_call_multi=P_ * n_seg, expand_gather_window_call=P_ * n_upd,
                jitter_moments_call=P_ * n_upd, expand_gather_call=0, gps_weights_call=0,
                systematic_counts=0)
    if launches != want:
        raise AssertionError(f"sharded PF: launches {launches}, expected {want}")
    (fin0, out0), ms0, wall0 = timed(lambda: run(None))
    for name, a, b in (("bank", fin1.particles, fin0.particles), ("mean", out1["mean"], out0["mean"]),
                       ("cov", out1["cov"], out0["cov"])):
        if not bitwise(a, b):
            raise AssertionError(f"sharded PF: {name} differs from the unsharded replay")
    reps1, reps0 = [ms1], [ms0]
    for _ in range(2):                                           # in turns
        reps1.append(timed(lambda: run(pm))[1])
        reps0.append(timed(lambda: run(None))[1])
    # one forced exact-branch resample: every slot takes particle 777
    bank = fin0.particles
    w = torch.zeros(n, device=dev)
    w[777] = 1.0
    before = resample_dist.exact_fallbacks
    got = resample_dist.systematic_resample_gather_dist(bank, w, 0.5, pm)
    if resample_dist.exact_fallbacks != before + 1:
        raise AssertionError("degenerate weights did not take the exact branch")
    if not bitwise(got, PK.expand_gather_call(RS.systematic_counts(w, 0.5), bank)):
        raise AssertionError("exact branch: differs from the unsharded gather")
    T = tl_pf.num_ticks
    res = dict(ms=statistics.median(reps1), replays_ms=reps1, unsharded_ms=statistics.median(reps0),
               unsharded_replays_ms=reps0, launches=launches, exact_fallbacks=fallbacks)
    print(f"phase 21b: run_fast_segmented N={n} T={T} ({n_seg} segments, {n_upd} GPS updates) "
          f"over {P_} particle shards on one card: {res['ms']:.2f} ms (median of "
          + ", ".join(f"{r:.2f}" for r in reps1) + f"; the first {wall1:.3f} s host) against "
          f"{res['unsharded_ms']:.2f} ms unsharded (" + ", ".join(f"{r:.2f}" for r in reps0)
          + f"); bank, mean and cov bitwise the unsharded replay's; launches {launches}; exact "
          f"branches {fallbacks} in the replay, 1 forced (degenerate weights), bitwise the "
          f"unsharded gather", flush=True)
    return res


def mesh_fleets_phase(dev, cfg, params, tl, counters):
    """Phase 21c-d: the mission-sharded fleets on one card, each bitwise
    its unsharded run: ``ekf_slam.run_fleet(device_mesh=make_mesh(
    mission=4))`` at the headline (B=128, L=64, M=8, T=601, graphed per
    mission shard), the SLAM + PF fleet over ``make_mesh(mission=2,
    particle=2)`` at slam-pf-fleet128's width (T cut to MESH_SPF_T, the
    systematic scheme) and ``run_raycast_fleet(device_mesh=make_mesh(
    mission=4))`` at B=1024 (T cut to MESH_RC_T)."""
    import torch

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.io.workloads import raycast_fleet_inputs
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.models import particle_filter as PF
    from smarc_navigation_tpu_torch.parallel import fleet as FL
    from smarc_navigation_tpu_torch.parallel import mesh

    def mission_mesh(m, p=1):
        return mesh.make_mesh(mission=m, particle=p, devices=[dev] * (m * p))

    def sharded(what, run_sh, run_un, T, launches):
        run_sh()                    # warm-up: each graph key's first call (eager, capture)
        run_un()
        for f in counters:
            f.launches = 0
        got, ms_sh, _ = timed(run_sh)
        n = {f.__name__: f.launches for f in counters}
        for k in ("da_lanes", "sequential_update_fleet", "symmetric_downdate"):
            if n[k] != launches:
                raise AssertionError(f"{what}: launches {n}, expected {launches} of {k}")
        want, ms_un, _ = timed(run_un)
        assert_bitwise(got, want, what)
        print(f"phase 21 {what}: bitwise the unsharded run; {ms_sh:.1f} ms sharded against "
              f"{ms_un:.1f} ms unsharded ({ms_sh * 1e3 / T:.1f} / {ms_un * 1e3 / T:.1f} us per "
              f"fleet tick); launches {n}", flush=True)
        return dict(ms=ms_sh, unsharded_ms=ms_un, launches=n)

    res = {}
    B, T = tl.ticks.shape
    res["slam"] = sharded(f"ekf_slam.run_fleet B={B} T={T} over mission=4",
                          lambda: S.run_fleet(tl, params, cfg, device_mesh=mission_mesh(4)),
                          lambda: S.run_fleet(tl, params, cfg), T, 4 * T)
    tls = tl.map(lambda x: x[:, :MESH_SPF_T])
    pcfg = PFConfig(particle_count=SPF_N)
    pp = PF.make_params(pcfg, device=dev)
    res["slam_pf"] = sharded(
        f"fleet.run_fleet B={B} T={MESH_SPF_T} N={SPF_N} over mission=2 x particle=2",
        lambda: FL.run_fleet(tls, cfg, params, pcfg, pp, SPF_N, device_mesh=mission_mesh(2, 2),
                             seed=4),
        lambda: FL.run_fleet(tls, cfg, params, pcfg, pp, SPF_N, seed=4, pf_scheme="systematic"),
        MESH_SPF_T, 2 * MESH_SPF_T)
    rcfg, spec, gt, lms, lmm = raycast_fleet_inputs(RC_B, MESH_RC_T)
    gt, lms, lmm = (torch.as_tensor(x, device=dev) for x in (gt, lms, lmm))
    rp = S.make_params(rcfg, device=dev)
    res["raycast"] = sharded(
        f"run_raycast_fleet B={RC_B} T={MESH_RC_T} over mission=4",
        lambda: FL.run_raycast_fleet(gt, lms, lmm, rcfg, rp, spec, device_mesh=mission_mesh(4),
                                     use_da_kernel=True),
        lambda: FL.run_raycast_fleet(gt, lms, lmm, rcfg, rp, spec, use_da_kernel=True),
        MESH_RC_T, 4 * MESH_RC_T)
    return res


def mesh_phase(dev, cfg, params, tl, counters):
    """Phase 21: the multi-device layer with four shards on the one card."""
    from smarc_navigation_tpu_torch.io.workloads import combined_workload

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _tls, tlp_np = combined_workload(cfg, 60.0)
    tl_pf = tlp_np.to(dev)
    win, k8s = mesh_kernels_phase(dev, tl_pf)
    pf = mesh_pf_phase(dev, tl_pf)
    fleets = mesh_fleets_phase(dev, cfg, params, tl, counters)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(window=win, k8_shard=k8s, pf=pf, fleets=fleets)


K15_SEEDS = 3        # phase 6b: states per shape
K15_ATTITUDES = ((0.3, -0.2, 2.9), (3.14159265, 0.1, -3.14159265), (-0.4, 1.5707963, 1.0))
K15_RTOL = 1e-6      # phase 6b: Σ's position rows, of each block's largest entry


def k15_sigma_check(got, want):
    """K15's Σ' against the twin's -> (the largest error of the position
    rows as a share of their block's largest entry, the largest absolute
    error anywhere). The attitude rows and
    columns are R's columns and zeros in both (A's attitude rows are zero),
    so they and Σ past the pose rows and columns must be bitwise; the
    position rows Σ'[0:3, 0:3] and Σ'[0:3, 6:] (and their mirror) are
    within K15_RTOL of their own block's largest entry."""
    import torch

    bitwise = (("attitude rows", got[3:6], want[3:6]),
               ("attitude columns", got[:, 3:6], want[:, 3:6]),
               ("landmark block", got[6:, 6:], want[6:, 6:]),
               ("mirror", got[6:, 0:6], got[0:6, 6:].T))
    for name, a, b in bitwise:
        if not torch.equal(a, b):
            raise AssertionError(f"K15: Sigma {name} not bitwise the twin")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("K15: non-finite Sigma")
    rel = 0.0
    for a, b in ((got[0:3, 0:3], want[0:3, 0:3]), (got[0:3, 6:], want[0:3, 6:])):
        a, b = a.double(), b.double()
        rel = max(rel, float((a - b).abs().max()) / float(b.abs().max()))
    if rel > K15_RTOL:
        raise AssertionError(f"K15: Sigma position rows {rel:.3e} of their block > {K15_RTOL}")
    return rel, float((got.double() - want.double()).abs().max())


def k15_phase(dev):
    """Phase 6b: K15 ``online_predict`` at B=1, L=64 and L=256, against its
    plain twin ``predict(state, odom_pose(v), params)`` on the card, on
    random symmetric positive definite Σ and 13-wide odometry (an attitude
    at ±π and one at pitch π/2 among them) a step of a few cm to m from
    ``mu_auv_odom``, as a log's ticks are: μ's position, ``mu_auv_odom`` and
    μ past the pose bitwise, the attitude within 2 ulp, Σ by
    ``k15_sigma_check``; its device time, the host's time per call beside
    the twin's (back to back), one launch a call. Returns {L: result}."""
    import torch

    from smarc_navigation_tpu_torch.configs import EKFSlamConfig
    from smarc_navigation_tpu_torch.models import ekf_slam as S
    from smarc_navigation_tpu_torch.ops import slam_kernels as K2
    from smarc_navigation_tpu_torch.utils.geometry import odom_pose, quat_from_rpy_np

    res = {}
    for L in (64, 256):
        D = 6 + 3 * L
        cfg = dataclasses.replace(EKFSlamConfig(), max_landmarks=L)
        att_ulp = sigma_rel = sigma_err = 0.0
        for seed in range(K15_SEEDS):
            rng = np.random.default_rng(seed)
            X = rng.normal(0.0, 1.0, (D, D)) / np.sqrt(D)
            f32 = dict(dtype=torch.float32, device=dev)
            st0 = S.init_state(cfg, device=dev)._replace(
                mu=torch.tensor(rng.normal(0.0, 20.0, D), **f32),
                Sigma=torch.tensor(X @ X.T + 1e-3 * np.eye(D), **f32))
            params = S.make_params(cfg, device=dev)
            for rpy in K15_ATTITUDES:
                pos = rng.normal(0.0, 20.0, 3)
                step = rng.uniform(0.02, 2.0, 3) * rng.choice((-1.0, 1.0), 3)
                st = st0._replace(mu_auv_odom=torch.tensor(pos - step, **f32))
                v = torch.tensor(np.concatenate([pos, quat_from_rpy_np(np.asarray(rpy)),
                                                 rng.normal(0.0, 1.0, 6)]), **f32)
                got = K2.online_predict(st, v, params)
                want = S.predict(st, odom_pose(v), params)
                torch.cuda.synchronize()
                for name, a, b in (("mu position", got.mu[0:3], want.mu[0:3]),
                                   ("mu landmarks", got.mu[6:], want.mu[6:]),
                                   ("mu_auv_odom", got.mu_auv_odom, want.mu_auv_odom)):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K15 L={L} {rpy}: {name} not bitwise the twin")
                w = want.mu[3:6].cpu().numpy()
                ulp = float((np.abs(got.mu[3:6].cpu().numpy().astype(np.float64) - w)
                             / np.spacing(np.abs(w))).max())
                if ulp > 2.0:
                    raise AssertionError(f"K15 L={L} {rpy}: attitude {ulp:.1f} ulp")
                att_ulp = max(att_ulp, ulp)
                rel, err = k15_sigma_check(got.Sigma, want.Sigma)
                sigma_rel, sigma_err = max(sigma_rel, rel), max(sigma_err, err)

        def k15():
            return K2.online_predict(st, v, params)

        def plain():
            return S.predict(st, odom_pose(v), params)

        n0 = K2.online_predict.launches
        host_ms = wall_ms(k15, 200)
        if K2.online_predict.launches - n0 != 201:
            raise AssertionError(f"K15 L={L}: {K2.online_predict.launches - n0} launches for "
                                 f"201 calls")
        plain_host_ms = wall_ms(plain, 200)
        ms = device_ms(k15, 30, "online_predict_kernel")
        plain_dev_ms = call_device_ms(plain, 30)
        # float work: A Σ[0:6, :], 72 a column; (A Σ00) Aᵀ, 864
        bnd = bound(nbytes(st.mu, st.Sigma, st.mu_auv_odom, v, params.R, got.mu, got.Sigma,
                           got.mu_auv_odom), 72 * D + 864)
        res[L] = dict(err=sigma_err, rel=sigma_rel, attitude_ulp=att_ulp, ms=ms, host_ms=host_ms,
                      plain_host_ms=plain_host_ms, plain_ms=plain_dev_ms, bound=bnd, D=D)
        print(f"K15 online_predict L={L} D={D}: mu position, mu_auv_odom, Sigma's attitude "
              f"rows and columns and Sigma past the pose bitwise, attitude {att_ulp:.1f} ulp, "
              f"Sigma position rows {sigma_rel:.3e} of their block ({sigma_err:.3e} abs); "
              f"device "
              f"{ms * 1e3:.2f} us (twin {plain_dev_ms * 1e3:.2f} us of device work a call), host "
              f"{host_ms * 1e3:.1f} us a call back to back against the twin's "
              f"{plain_host_ms * 1e3:.1f} us; one launch a call; bound {bnd[0] * 1e3:.2f} us "
              f"({bnd[1]})", flush=True)
    return res


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
    from smarc_navigation_tpu_torch.utils.geometry import odom_pose

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
    pose_t = odom_pose(odom.value[:, T_WARM]).contiguous()
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
    k1, got = k1_case("MBES", da_args, da_kw, zm, 3)
    k1_err, k1_ms, k1_bound = k1["err"], k1["ms"], k1["bound"]

    def k1_call():
        return K1.da_lanes(*da_args, **da_kw)

    k1_wall = wall_ms(k1_call, 50)
    k1_plain_ms = wall_ms(lambda: K1.da_lanes_reference(*da_args, **da_kw), 3)
    print(f"K1 da_lanes MBES: {k1_wall:.4f} ms per call back to back, plain {k1_plain_ms:.2f} ms",
          flush=True)
    # K11 on the same (B, L+M, M) cost tables: the JV's share of K1
    k11_64 = k11_case(f"on the L={L} DA tables", K1.da_tables_reference(
        *da_args, **da_kw)[0].contiguous(), got[0])
    # one mission, as the combined mission's compact replay runs it
    one = [x[0:1].contiguous() if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == B
           else x for x in da_args]
    k1_b1, _ = k1_case("MBES, one mission", one, {k: v[0:1].contiguous() if k != "sensor" else v
                                                  for k, v in da_kw.items()}, zm[0:1], 3)

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
    k1f, _ = k1_case("FLS", fls_args, fls_kw, zfm, 2)
    k1f_err = k1f["err"]

    # K2 on K1's selection, with the predict, the band and the candidates
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = got
    lm_ix = 6 + 3 * slot
    k2_args = (st_p.Sigma, st_p.mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_cov,
               cand, a8, band)
    got2 = K2.sequential_update_fleet(*k2_args)                   # phase 1 + K12
    torch.cuda.synchronize()
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
    k2_plain_ms = wall_ms(lambda: K2.sequential_update_fleet_reference(*k2_args), 10)
    k2_bound = bound(nbytes(*k2_args, *got2), k2_flops(B, 6 + 3 * L, M, 3, True))
    print(f"K2 sequential_update_fleet: max err Sigma {errs[0][0]:.3e} mu {errs[1][0]:.3e} "
          f"band {errs[2][0]:.3e}; phase 1 {k2_t['phase1_kernel']:.4f} + K12 "
          f"{k2_t['downdate_kernel']:.4f} = {k2_ms:.4f} ms device ({k2_wall:.4f} ms per call back "
          f"to back), plain {k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]})",
          flush=True)
    _, _, P1, U, V, act = K2.phase1(*k2_args)
    k12_64 = k12_phase(st_p.Sigma, U, V, P1, act, f"L={L}")

    # K3 on the mission with the most updates (Σ predicted by the plain path)
    b = int(do.sum(1).argmax())
    st_pp, _ = S._fleet_predict(st, pose_t, valid_t, params, predict_sigma=True)
    k3_args = (st_pp.Sigma[b].contiguous(), st_pp.mu[b].contiguous(), H_sel[b],
               SinvH[b], nu_sel[b], lm_ix[b], do[b], add[b], new_cov)
    got3 = K2.sequential_update(*k3_args)                          # phase 1 + K12
    torch.cuda.synchronize()
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
    k3_plain_ms = wall_ms(lambda: K2.sequential_update_reference(*k3_args), 10)
    k3_bound = bound(nbytes(*k3_args, *got3), k2_flops(1, 6 + 3 * L, M, 3, False))
    print(f"K3 sequential_update (mission {b}, {int(do[b].sum())} updates): max err "
          f"{k3_err:.3e}; phase 1 {k3_t['phase1_kernel']:.4f} + K12 {k3_t['downdate_kernel']:.4f} "
          f"= {k3_ms:.4f} ms device ({k3_wall:.4f} ms per call back to back), plain "
          f"{k3_plain_ms:.3f} ms, bound {k3_bound[0]:.4f} ms ({k3_bound[1]})", flush=True)

    # --- 3b. the slice-3 kernels at L=256 ---------------------------------------
    k256 = slam256_kernels_phase(dev, cfg256, params256, tl256)
    # --- 3c. K1 and K11 past the register JV --------------------------------------
    big = big_jv_phase(dev, cfg256, params256, tl256)

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

    # --- 6. single-mission step through K1 + K2 at B=1 ----------------------------
    launches = {f.__name__: f.launches for f in counters}
    mask0 = tl_np.events["mbes"].mask[0]
    k = int(next(i for i in range(T - 1, 0, -1) if mask0[i].any()))
    st0 = S.SlamState(*(x[0].contiguous() for x in final))
    tick = tl.map(lambda x: x[0, k])
    n15 = K2.online_predict.launches
    s_k, o_k = S.step(cfg, params, st0, tick)                        # auto -> K15, K1 + K2
    step_launches = {f.__name__: f.launches - launches[f.__name__] for f in counters}
    step_launches["online_predict"] = K2.online_predict.launches - n15
    real_predict = K2.online_predict
    K2.online_predict = lambda st, v, p: S.predict(st, odom_pose(v), p)
    try:
        s_p, o_p = S.step(cfg, params, st0, tick, update_mode="full")  # twin, plain dense
    finally:
        K2.online_predict = real_predict
    torch.cuda.synchronize()
    if not torch.equal(o_k["matched_mbes"], o_p["matched_mbes"]):
        raise AssertionError("step: matched_mbes differs between K1 + K2 and the dense path")
    err, tol = max_err(s_k.mu, s_p.mu)
    if err > tol:
        raise AssertionError(f"step: mu differs by {err:.3e} > {tol:.3e}")
    if (step_launches["da_lanes"], step_launches["sequential_update_fleet"],
            step_launches["symmetric_downdate"], step_launches["sequential_update"],
            step_launches["online_predict"]) != (1, 1, 1, 0, 1):
        raise AssertionError(f"step: launches {step_launches}, expected K15, K1, K2 and K12 once")
    print(f"step (mission 0, tick {k}): matched {o_k['matched_mbes'].tolist()}, "
          f"mu err vs dense {err:.3e}; launches {step_launches}", flush=True)
    k15 = k15_phase(dev)
    g_head["share"] = device_share(lambda: S.run_fleet(tl, params, cfg),
                                   {"da_kernel": T, "phase1_kernel": T, "downdate_kernel": T},
                                   ms, "headline run_fleet (graphed)")

    # --- 5b-5c. the L=256 replays in both semantics -----------------------------
    l256, g256 = slam256_replays(dev, cfg256, params256, tl256, counters)

    # --- 7-10. the PF kernels, slice, headline and the combined mission ------
    pk, pf_launch, pt_launch, cb_launch = pf_main_paths(dev, cfg, params, counters)

    # --- 11-15. the localization and 15-state fleets ----------------------------
    k9, k10, (fl_launch, g_filters) = filter_fleets(dev)

    # --- 16-18. the raycast fleet, dead reckoning, the SLAM + PF fleet ---------
    rck = raycast_kernels_phase(dev)
    rc_launch, g_rc = raycast_replay(dev, counters)
    s12 = slice12_checks(dev)
    # --- 19. the SLAM + PF mission fleet at the headline's width -------------
    spf_launch, g_spf = slam_pf_replay(dev, cfg, params, tl, counters)
    # --- 20. the mission CLI on the card ----------------------------------------
    cli = cli_phase(dev)
    # --- 21. the multi-device layer: four shards on the one card ---------------
    mp = mesh_phase(dev, cfg, params, tl, counters)
    mpl = mp["pf"]["launches"]

    def entry(name, source, replaces, n, err, ms_, plain, bnd, library=None, **extra):
        return dict(name=name, route="cuda", source=f"smarc_navigation_tpu_torch/csrc/{source}",
                    replaces=f"smarc_navigation_tpu/ops/{replaces}", launches=n,
                    max_abs_err=err, ms=ms_, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                    library_ms=library, **extra)

    k12_256 = k256["K12"]

    def brief(r):
        return dict(ms=r["ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
                    max_abs_err=r["err"], shape=list(r["shape"]))

    k1_l256 = {k: brief(k256[k]) for k in ("K1_pose_rows", "K1_pose_rows_fls", "K1_full",
                                           "K1_full_fls", "K1_pose_rows_M16")}
    rk2, rk12 = rck["K2"], rck["K12"]
    kernels = [
        # K1 at the L=64 headline (MBES, with predict and band); beside it the
        # FLS form, one mission, K11 on the same tables (the JV's share), the
        # L=256 forms and the launches of each main path
        entry("da_lanes", "slam_da.cu", "slam_da_kernels.py:581", launches["da_lanes"],
              max([k1_err, k1f_err, k1_b1["err"], rck["K1"]["err"]]
                  + [v["max_abs_err"] for v in k1_l256.values()]),
              k1_ms, k1_plain_ms, k1_bound, fls=brief(k1f), one_mission=brief(k1_b1),
              jv_alone=brief(k11_64), L256=k1_l256, past_register_jv=big["K1"],
              B1024=brief(rck["K1"]),
              launches_by_path={"slam-fleet128-L64": launches["da_lanes"],
                                "slam-fleet32-L256-full": l256["full"]["da_lanes"],
                                "slam-fleet32-L256-marginal": l256["marginal"]["da_lanes"],
                                "combined-1M": cb_launch["da_lanes"],
                                "raycast-fleet1024": rc_launch["da_lanes"],
                                "slam-pf-fleet128": spf_launch["da_lanes"],
                                **{p: cli[p]["da_lanes"]
                                   for p in ("cli-replay", "cli-demo", "chunked-replay")}}),
        # K2 and K3: the device time of phase 1 + K12
        entry("sequential_update_fleet", "slam_update.cu", "slam_kernels.py:791",
              launches["sequential_update_fleet"], max(k2_err, k256["K2_774"]["err"], rk2["err"]),
              k2_ms, k2_plain_ms, k2_bound, phase1_ms=k2_t["phase1_kernel"],
              downdate_ms=k2_t["downdate_kernel"],
              D774=dict(ms=k256["K2_774"]["ms"], phase1_ms=k256["K2_774"]["phase1_ms"],
                        downdate_ms=k12_256["ms"], bound_ms=k256["K2_774"]["bound"][0]),
              B1024=dict(ms=rk2["ms"], phase1_ms=rk2["phase1_ms"], downdate_ms=rk2["downdate_ms"],
                         plain_ms=rk2["plain_ms"],
                         bound_ms=rk2["bound"][0], bound_by=rk2["bound"][1],
                         max_abs_err=rk2["err"], shape=list(rk2["shape"])),
              launches_by_path={"slam-fleet128-L64": launches["sequential_update_fleet"],
                                "slam-fleet32-L256-full": l256["full"]["sequential_update_fleet"],
                                "raycast-fleet1024": rc_launch["sequential_update_fleet"],
                                "slam-pf-fleet128": spf_launch["sequential_update_fleet"],
                                **{p: cli[p]["sequential_update_fleet"]
                                   for p in ("cli-replay", "cli-demo", "chunked-replay")}}),
        entry("sequential_update", "slam_update.cu", "slam_kernels.py:213",
              launches["sequential_update"], k3_err, k3_ms, k3_plain_ms, k3_bound,
              phase1_ms=k3_t["phase1_kernel"], downdate_ms=k3_t["downdate_kernel"],
              launches_by_path={p: cli[p]["sequential_update"]
                                for p in ("cli-replay", "cli-demo", "chunked-replay")}),
        entry("sequential_update_marginal_fleet", "slam_marginal.cu", "slam_kernels.py:1124",
              l256["marginal"]["sequential_update_marginal_fleet"], k256["K4"]["err"],
              k256["K4"]["ms"], k256["K4"]["plain_ms"], k256["K4"]["bound"],
              M16=dict(ms=k256["K4_M16"]["ms"], bound_ms=k256["K4_M16"]["bound"][0],
                       bound_by=k256["K4_M16"]["bound"][1], max_abs_err=k256["K4_M16"]["err"])),
    ] + [
        entry(name, src, rep, cnt[name], pk[k]["err"], pk[k]["ms"], pk[k]["plain_ms"], pk[k]["bound"],
              pk[k].get("library_ms"), **{x: pk[k][x] for x in ("nticks_ms", "fit", "no_jitter",
                                                                 "by_weights", "kernel_ms")
                                          if x in pk[k]},
              **({"launches_by_path": {"cli-pf": cli["cli-pf"][name],
                                       **({"pf-1M-60s-mesh4": mpl[name]} if name in mpl else {})}}
                 if k in ("K5", "K7") else {}),
              **({"shard": mp["k8_shard"], "launches_by_path": {"pf-1M-60s-mesh4": mpl[name]}}
                 if k == "K8" else {}))
        for k, name, src, rep, cnt in (
            ("K5", "predict_call_multi", "pf_predict.cu", "pf_kernels.py:820", pf_launch),
            ("K6", "predict_call", "pf_predict.cu", "pf_kernels.py:865", pt_launch),
            ("K7", "expand_gather_call", "pf_resample.cu", "pf_kernels.py:562", pf_launch),
            ("K8", "jitter_moments_call", "pf_resample.cu", "pf_kernels.py:472", mpl))
    ] + [
        # K7's window form: a particle shard's slots from its halo-extended
        # window (resample_dist.py:148 in the reference), timed at an interior
        # shard of the 2^20 bank split four ways; launches from phase 21b
        entry("expand_gather_window_call", "pf_resample.cu", "pf_kernels.py:562",
              mpl["expand_gather_window_call"], mp["window"]["err"], mp["window"]["ms"],
              mp["window"]["plain_ms"], mp["window"]["bound"], None,
              kernel_ms=mp["window"]["kernel_ms"], shape=mp["window"]["shape"],
              launches_by_path={"pf-1M-60s-mesh4": mpl["expand_gather_window_call"]}),
    ] + [
        # K13 / K14, the GPS update's weights and counts (no TPU kernel: the
        # JAX package leaves both to XLA), at 2^20, with their times at a
        # bank that does not tile (10^6) and K14's at the SLAM + PF fleet's
        # (8, 1024) banks; launches by path
        dict(entry(name, "pf_update.cu", "", pf_launch[name], pk[k]["err"], pk[k]["ms"],
                   pk[k]["plain_ms"], pk[k]["bound"], None,
                   **{x: {**{y: v for y, v in pk[k][x].items() if y != "bound"},
                          "bound_ms": pk[k][x]["bound"][0]}
                      for x in ("non_tiling", "fleet") if x in pk[k]},
                   launches_by_path={"pf-per-tick": pt_launch[name], "combined-1M": cb_launch[name],
                                     "cli-pf": cli["cli-pf"][name], "pf-1M-60s-mesh4": mpl[name],
                                     **({"slam-pf-fleet8-systematic": s12["fleet_k14"]["systematic"]}
                                        if k == "K14" else {})}),
             replaces=None)
        for k, name in (("K13", "gps_weights_call"), ("K14", "systematic_counts"))
    ] + [
        entry("hungarian_lanes", "slam_da.cu", "slam_da_kernels.py:616",
              l256["full"]["hungarian_lanes"], k256["K11"]["err"], k256["K11"]["ms"],
              k256["K11"]["plain_ms"], k256["K11"]["bound"], shape=list(k256["K11"]["shape"]),
              L64_tables=brief(k11_64), past_register_jv=big["K11"]),
        # K12 at the L=64 headline (launches: phase 5), and at L=256
        entry("symmetric_downdate", "slam_downdate.cu", "slam_kernels.py:807",
              launches["symmetric_downdate"], max(k12_64["err"], k12_256["err"], rk12["err"]),
              k12_64["ms"],
              k12_64["plain_ms"], k12_64["bound"], k12_64["library_ms"],
              one_row_ms=k12_64["one_row_ms"], copy_ms=k12_64["copy_ms"],
              L256=dict(launches=l256["full"]["symmetric_downdate"], max_abs_err=k12_256["err"],
                        ms=k12_256["ms"], plain_ms=k12_256["plain_ms"],
                        bound_ms=k12_256["bound"][0], bound_by=k12_256["bound"][1],
                        library_ms=k12_256["library_ms"], one_row_ms=k12_256["one_row_ms"],
                        copy_ms=k12_256["copy_ms"]),
              B1024=dict(launches=rc_launch["symmetric_downdate"], max_abs_err=rk12["err"],
                         ms=rk12["ms"], plain_ms=rk12["plain_ms"], bound_ms=rk12["bound"][0],
                         bound_by=rk12["bound"][1], library_ms=rk12["library_ms"],
                         one_row_ms=rk12["one_row_ms"], copy_ms=rk12["copy_ms"]),
              launches_by_path={"slam-fleet128-L64": launches["symmetric_downdate"],
                                "slam-fleet32-L256-full": l256["full"]["symmetric_downdate"],
                                "raycast-fleet1024": rc_launch["symmetric_downdate"],
                                "slam-pf-fleet128": spf_launch["symmetric_downdate"],
                                **{p: cli[p]["symmetric_downdate"]
                                   for p in ("cli-replay", "cli-demo", "chunked-replay")}}),
        # K15, the online step's predict (no TPU kernel: the JAX package
        # leaves it to XLA), at L=64 with its L=256 numbers; launches: the
        # CLI's replay, one a tick
        dict(entry("online_predict", "slam_predict.cu", "", cli["cli-replay"]["online_predict"],
                   k15[64]["err"], k15[64]["ms"], k15[64]["plain_ms"], k15[64]["bound"],
                   attitude_ulp=max(r["attitude_ulp"] for r in k15.values()),
                   sigma_block_rel=max(r["rel"] for r in k15.values()),
                   host_ms=k15[64]["host_ms"], plain_host_ms=k15[64]["plain_host_ms"],
                   L256={x: (k15[256][x] if x != "bound" else k15[256][x][0])
                         for x in ("err", "ms", "host_ms", "plain_host_ms", "plain_ms", "bound")}),
             replaces=None),
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
               "ekf15-dual64": g_filters["ekf15_dual"], "raycast-fleet1024": g_rc,
               "slam-pf-fleet128": g_spf}
    for name, g in graphed.items():
        print(f"graph summary {name}: us/tick first call {g['first_us']:.1f}, steady "
              f"{g['steady_us']:.1f}, eager {g['eager_us']:.1f}; path kernels "
              f"{100 * g['share']:.1f} % of the steady replay; graphed == eager bitwise", flush=True)
    print(f"raycast-fleet1024: {RC_B * RC_T / (g_rc['ms'] / 1e3):.0f} steps/s graphed "
          f"({g_rc['ms'] * 1e3 / RC_T:.1f} us/fleet tick); sam-dr-fleet256: "
          f"{s12['dr']['us_per_tick']:.3f} us/fleet tick ({DR_B / (s12['dr']['us_per_tick'] / 1e6):.4g} "
          f"ticks/s), slope {s12['dr']['slope_us']:.3f} us/fleet tick; slam-pf-fleet128: "
          f"{g_spf['ms'] * 1e3 / SPF_T:.1f} us/fleet tick graphed (median of "
          + ", ".join(f"{r * 1e3 / SPF_T:.1f}" for r in g_spf["replays_ms"]) + "); "
          f"raycast-fleet1024 replays: "
          + ", ".join(f"{r * 1e3 / RC_T:.1f}" for r in g_rc["replays_ms"]) + " us/fleet tick",
          flush=True)
    fl = mp["fleets"]
    print(f"mesh summary (four shards on one card; no scaling is measured): pf-1M-60s "
          f"{mp['pf']['ms']:.2f} ms over 4 particle shards against {mp['pf']['unsharded_ms']:.2f} "
          f"unsharded; slam-fleet128-L64 over 4 mission shards {fl['slam']['ms']:.1f} against "
          f"{fl['slam']['unsharded_ms']:.1f} ms; slam-pf-fleet128 (T={MESH_SPF_T}) over 2 x 2 "
          f"{fl['slam_pf']['ms']:.1f} against {fl['slam_pf']['unsharded_ms']:.1f} ms; "
          f"raycast-fleet1024 (T={MESH_RC_T}) over 4 {fl['raycast']['ms']:.1f} against "
          f"{fl['raycast']['unsharded_ms']:.1f} ms; every sharded run bitwise its unsharded run",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
