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
Their seven kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
at first use by ``_build.py``.

Layout (same paths as the reference):
  utils/     geometry, linalg
  io/        numpy mission simulator, the headline and combined workloads
  ops/       timeline, assignment, resampling, slam_da_kernels (K1),
             slam_kernels (K2/K3), pf_kernels (K5-K8)
  parallel/  fleet.batch_timelines, fleet.run_combined
  models/    ekf_slam, particle_filter
"""

import torch as _torch

__version__ = "0.1.0"

# Covariance updates are numerically delicate: TF32 keeps ~3 decimal digits
# and corrupts Σ the same way the TPU's bf16 passes do (the reference forces
# "highest" matmul precision at import for that reason). Full f32 everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
