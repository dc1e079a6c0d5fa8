"""The numbers that judge a particle-filter replay against the float64
reference (``reference/pf_mission.py``) replayed from the same generator
over the same mission. The reference breaks near ties of the resample as
the judged run did (its ancestor wherever the reference's own point lies
within float32 rounding of that ancestor's interval), so the two banks
hold the same particles from the first tick to the last and differ by the
judged run's rounding alone: every number is absolute, at any bank size.

- ``mean_err``: the largest difference of the mean x, y (m) and yaw (rad,
  wrapped) of any tick.
- ``cov_err``: the largest difference of the 3x3 position covariance of
  any tick, over the reference's largest entry at that tick.
- ``bank_err``: the largest difference of any particle of the final bank,
  every row (m; rad, wrapped, for roll, pitch and yaw).
- ``updates_err``: the resamples the judged run made (its calls of the
  port's ``systematic_counts``) against the reference's surfaced fixes
  (exact: every surfaced fix is weighed and resampled once).
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("mean_err", "cov_err", "bank_err", "updates_err")


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def numbers(prog: dict, ref: dict) -> dict:
    """prog and ref: ``mean`` (T, 6), ``cov`` (T, 3, 3), final ``bank``
    (6, n); prog also ``resamples`` (its count of resamples), ref also
    ``updated`` (T,) (the surfaced fixes)."""
    d = np.abs(np.asarray(prog["mean"], np.float64) - ref["mean"])[:, (0, 1, 5)]
    d[:, 2] = np.abs(_wrap(d[:, 2]))
    c_ref = np.asarray(ref["cov"], np.float64)
    c_scale = np.abs(c_ref).reshape(len(c_ref), -1).max(1)
    c_err = np.abs(np.asarray(prog["cov"], np.float64) - c_ref).reshape(len(c_ref), -1).max(1)
    b = np.abs(np.asarray(prog["bank"], np.float64) - np.asarray(ref["bank"], np.float64))
    b[3:] = np.abs(_wrap(b[3:]))
    out = dict(
        mean_err=float(d.max()),
        cov_err=float((c_err / c_scale).max()),
        bank_err=float(b.max()),
        updates_err=float(abs(int(prog["resamples"]) - int(np.sum(ref["updated"])))))
    # a NaN anywhere in the judged run's outputs reads as the worst number
    return {k: (v if math.isfinite(v) else 1e30) for k, v in out.items()}


def control(tl: dict, cfg: dict, n: int, make_gen, device="cpu", hold=None) -> dict:
    """The control's numbers: the reference with its bank and weights held
    in ``hold`` (float16 by default) in the program's place, from the same
    generator (``make_gen()`` gives a fresh one each call), judged as the
    program is: the float64 reference breaks near ties as the control
    resampled."""
    import torch

    from navbench.reference import pf_mission

    hold = torch.float16 if hold is None else hold
    ctl = pf_mission.replay(tl, cfg, n, make_gen(), device, hold=hold, record=True)
    ref = pf_mission.replay(tl, cfg, n, make_gen(), device, counts=ctl["counts"])
    return numbers(dict(ctl, resamples=len(ctl["counts"])), ref)
