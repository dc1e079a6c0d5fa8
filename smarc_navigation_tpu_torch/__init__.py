"""smarc_navigation_tpu_torch — the PyTorch + CUDA port of smarc_navigation_tpu.

The JAX package ``smarc_navigation_tpu`` is the reference: every public
function here keeps its counterpart's module path, argument order and
``(B, ...)`` shapes, and the tests hold the two against each other on the
same inputs. This package imports ``torch``, ``numpy`` and ``scipy`` only.

Slice 1 covers the EKF-SLAM fleet replay (``models.ekf_slam.run_fleet``)
and the single-mission ``step``/``run``; slice 2 the particle filter
(``models.particle_filter``: dense path and the kernel paths
``run_fast_segmented``/``run_fast``), the event-compacted SLAM replay
``run_fleet_compact`` and the combined mission ``parallel.fleet.run_combined``.
Slice 3 adds the L=256 SLAM fleet in both covariance semantics (K4, K11,
K12); slice 4 the EKF-localization fleet (``models.ekf_localization``, K9)
and the 15-state dual-EKF fleet (``models.ekf_15state``, K10). All twelve
kernels are hand-written CUDA C++ for Hopper (``csrc/``), built at first use
by ``_build.py``. On the card the SLAM, localization and 15-state fleet
replays run their tick loops as cached CUDA graphs (``utils/graphs.py``).
Slice 12 adds dead reckoning (``models.dead_reckoning``, ``ops.oned_kf``),
sonar perception (``ops.sonar``, ``ops.raycast``), the closed-loop raycast
fleet (``parallel.fleet.run_raycast_fleet``: K1, K2's phase 1 and K12,
graphed) and the SLAM + PF mission fleet (``parallel.fleet.run_fleet``:
K1 and K2 per tick, every particle bank stepped at once on its device,
graphed). Slice 13 adds the host and IO layer and the mission CLI
(``run.py``: ``demo``, ``pf``, ``replay``; the chunked replay with
checkpoint/resume ``io.replay``; ``native.py``, the host C++ JV and binner).
Slice 14 adds the multi-device layer: ``parallel.mesh`` (a (mission,
particle) grid of devices driven from one process, its shardings and
collectives), ``parallel.resample_dist`` (the distributed systematic
resample, on K7's window form) and every ``pmesh=`` / ``device_mesh=``
path (the particle-sharded PF on K5/K6 with a particle offset, K7's window
form and K8; the mission-sharded SLAM, raycast and SLAM + PF fleets).

Layout (same paths as the reference):
  run.py     the mission CLI (``python -m smarc_navigation_tpu_torch.run``)
  native.py  the host C++ runtime (``csrc/smarcnav_native.cc``, built by g++)
  utils/     geometry, linalg, geodesy, graphs (the cached CUDA graphs of the
             tick loops)
  io/        numpy mission simulator, the SLAM, combined, localization,
             15-state, dead-reckoning and raycast fleet workloads; logs,
             replay, metrics, observability, map_server, uw_gps, bag_convert
  ops/       timeline, assignment, bezier, oned_kf, resampling, sonar,
             raycast, slam_da_kernels (K1, K11), slam_kernels (K2-K4, K12),
             pf_kernels (K5-K8), loc_kernels (K9), ekf15_kernels (K10)
  parallel/  fleet: batch_timelines, run_combined, the SLAM + PF fleet,
             run_raycast_fleet; mesh; resample_dist
  models/    ekf_slam, particle_filter, ekf_localization, ekf_15state,
             motion_model, dead_reckoning, sensors
"""

import torch as _torch

__version__ = "0.1.0"

# Covariance updates are numerically delicate: TF32 keeps ~3 decimal digits
# and corrupts Σ the same way the TPU's bf16 passes do (the reference forces
# "highest" matmul precision at import for that reason). Full f32 everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
