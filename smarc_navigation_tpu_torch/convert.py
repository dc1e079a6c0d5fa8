"""State carried across from numpy: the port's NamedTuples and timelines
from plain numpy arrays, e.g. those of the reference package
(``{k: np.asarray(v) for k, v in jax_params._asdict().items()}``), so that
both packages can be fed identical inputs."""

from __future__ import annotations

import numpy as np
import torch

from .models.ekf_15state import Ekf15State
from .models.ekf_localization import EKFLocParams, EKFLocState
from .models.ekf_slam import MarginalFleetState, SlamParams, SlamState
from .models.particle_filter import FleetPFState, PFParams, PFState, fleet_keys
from .ops.timeline import timeline_from_numpy
from .parallel.fleet import FleetState

__all__ = ["slam_params_from_numpy", "slam_state_from_numpy",
           "marginal_state_from_numpy", "timeline_from_numpy",
           "pf_params_from_numpy", "pf_state_from_numpy",
           "loc_params_from_numpy", "loc_state_from_numpy", "ekf15_state_from_numpy",
           "fleet_state_from_numpy"]


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def slam_params_from_numpy(d: dict, device) -> SlamParams:
    """SlamParams from a dict of numpy arrays keyed by field name."""
    return SlamParams(**{k: _tensor(d[k], device) for k in SlamParams._fields})


def slam_state_from_numpy(d: dict, device) -> SlamState:
    """SlamState (single or batched) from a dict of numpy arrays; n_active
    becomes int32 and active bool, as the port keeps them."""
    kw = {k: _tensor(d[k], device) for k in SlamState._fields}
    kw["n_active"] = kw["n_active"].to(torch.int32)
    kw["active"] = kw["active"].to(torch.bool)
    return SlamState(**kw)


def marginal_state_from_numpy(d: dict, device) -> MarginalFleetState:
    """The marginal fleet's carry (pose rows + band) from a dict of numpy
    arrays; n_active becomes int32 and active bool, as the port keeps them."""
    kw = {k: _tensor(d[k], device) for k in MarginalFleetState._fields}
    kw["n_active"] = kw["n_active"].to(torch.int32)
    kw["active"] = kw["active"].to(torch.bool)
    return MarginalFleetState(**kw)


def pf_params_from_numpy(d: dict, device) -> PFParams:
    """PFParams from a dict of numpy arrays keyed by field name."""
    return PFParams(**{k: _tensor(d[k], device).to(torch.float32) for k in PFParams._fields})


def pf_state_from_numpy(d: dict, device, generator: torch.Generator | None = None) -> PFState:
    """PFState from a dict with ``particles`` (6, N) and ``t_prev``; the
    reference's PRNG key has no counterpart and is ignored, the port's
    generator is ``generator`` (a seed-0 one on ``device`` when None)."""
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    return PFState(particles=_tensor(d["particles"], device).to(torch.float32),
                   generator=g, t_prev=_tensor(d["t_prev"], device).to(torch.float32))


def loc_params_from_numpy(d: dict, device) -> EKFLocParams:
    """EKFLocParams from a dict of numpy arrays keyed by field name; the
    floats become float32 and map_mask bool, as ``make_params`` makes them."""
    kw = {k: _tensor(d[k], device).to(torch.float32) for k in EKFLocParams._fields}
    kw["map_mask"] = kw["map_mask"].to(torch.bool)
    return EKFLocParams(**kw)


def loc_state_from_numpy(d: dict, device) -> EKFLocState:
    """EKFLocState (single or batched) from a dict of numpy arrays."""
    return EKFLocState(**{k: _tensor(d[k], device).to(torch.float32) for k in EKFLocState._fields})


def ekf15_state_from_numpy(d: dict, device) -> Ekf15State:
    """Ekf15State (single or batched) from a dict of numpy arrays."""
    return Ekf15State(**{k: _tensor(d[k], device).to(torch.float32) for k in Ekf15State._fields})


def fleet_state_from_numpy(d: dict, device, seed: int = 0) -> FleetState:
    """The SLAM + PF fleet's state from ``{"slam": {...}, "pf": {...}}`` dicts
    of numpy arrays (the reference's FleetState as numpy): the batched
    SlamState as ``slam_state_from_numpy`` makes it; particles (B, 6, N) and
    t_prev (B,). The reference's PRNG keys have no counterpart and are
    ignored; each mission gets its key from ``seed``
    (``models.particle_filter.fleet_keys``)."""
    p = d["pf"]
    parts = _tensor(p["particles"], device).to(torch.float32)
    return FleetState(
        slam=slam_state_from_numpy(d["slam"], device),
        pf=FleetPFState(particles=parts, key=fleet_keys(parts.shape[0], seed, device),
                        t_prev=_tensor(p["t_prev"], device).to(torch.float32)))
