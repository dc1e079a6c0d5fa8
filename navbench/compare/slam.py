"""The numbers that judge an EKF-SLAM run against the float64 reference
(``reference/slam_fleet.py``) replayed over the same traffic with the
judged run's association decisions. The drivers that run the port's SLAM
filter report them; each cell's workload file gives a limit for each.

The reference breaks near ties of the assignment as the program did and
takes its own optimum wherever the program's association costs more than
that (``reference/slam_fleet.TIE``) or is no valid assignment, so a wrong
association shows in every number that follows it.

- ``pose_err``: the largest difference of any tick's 6-DOF pose (m, rad,
  the attitude wrapped). The predict and the update, every tick.
- ``mu_err``: the largest difference of the final state vector (pose and
  every landmark slot, m and rad).
- ``sigma_err``: the largest difference of the final covariance, over the
  largest entry of the reference's, worst mission.
- ``n_active_err``: the largest difference of the landmark count, any
  tick and the end (exact).
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("pose_err", "mu_err", "sigma_err", "n_active_err")
BLOCK = 16        # missions per block of the covariance comparison


def _wrapped(d: np.ndarray) -> np.ndarray:
    """Differences of poses or state vectors with components 3:6 wrapped."""
    d = d.copy()
    d[..., 3:6] = (d[..., 3:6] + math.pi) % (2 * math.pi) - math.pi
    return np.abs(d)


def numbers(prog: dict, ref: dict, rows=None) -> dict:
    """prog and ref: ``pose`` (N, T, 6), ``n_active_t`` (N, T), final ``mu``
    (N, D), ``Sigma`` (N, D, D), ``n_active`` (N,). ``rows`` (N,), if given,
    picks each program mission's row of ``ref``."""
    n = len(prog["Sigma"])
    rows = np.arange(n) if rows is None else np.asarray(rows)
    sig = 0.0
    for a in range(0, n, BLOCK):
        sig_p = np.asarray(prog["Sigma"][a:a + BLOCK], np.float64)
        sig_r = ref["Sigma"][rows[a:a + BLOCK]]
        scale = np.abs(sig_r).reshape(len(sig_r), -1).max(1)
        sig = max(sig, float((np.abs(sig_p - sig_r).reshape(len(sig_r), -1).max(1)
                              / scale).max()))
    n_err = max(np.abs(np.asarray(prog["n_active_t"]) - ref["n_active_t"][rows]).max(),
                np.abs(np.asarray(prog["n_active"]) - ref["n_active"][rows]).max())
    out = dict(
        pose_err=float(_wrapped(np.asarray(prog["pose"], np.float64) - ref["pose"][rows]).max()),
        mu_err=float(_wrapped(np.asarray(prog["mu"], np.float64) - ref["mu"][rows]).max()),
        sigma_err=sig,
        n_active_err=float(n_err))
    # a NaN anywhere in the program's outputs reads as the worst number
    return {k: (v if math.isfinite(v) else 1e30) for k, v in out.items()}


def notes(ref: dict) -> dict:
    """What the run's timing line prints beside the numbers (not compared):
    the largest gap of an applied or overruled assignment, the ticks
    overruled, the most landmark slots any mission filled."""
    gap = ref["gap"][np.isfinite(ref["gap"])]
    return dict(assoc_gap=float(gap.max()) if gap.size else 0.0,
                overruled=int(np.asarray(ref["overruled"]).sum()),
                n_active_max=int(np.asarray(ref["n_active_t"]).max()))


def control(cfg: dict, odom, valid, z, zmask, device="cpu") -> dict:
    """The control's numbers: the reference itself computed in TF32
    (``reference/slam_fleet.replay(precision="tf32")``) in the program's
    place over the same traffic, judged as the program is."""
    from navbench.reference import slam_fleet

    ctl = slam_fleet.replay(cfg, odom, valid, z, zmask, precision="tf32", device=device)
    ref = slam_fleet.replay(cfg, odom, valid, z, zmask, decisions=ctl["matched"], device=device)
    return numbers(ctl, ref)
