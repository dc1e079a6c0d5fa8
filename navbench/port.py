"""The boundary to the system under test, the PyTorch and CUDA port
(``smarc_navigation_tpu_torch``): its configuration type, and the
benchmark's traffic handed over in the port's own timeline containers.
The benchmark takes from the port only its entry points, its launch and
capture counters and its kernel names."""

from __future__ import annotations

import dataclasses

import numpy as np


def slam_config(fields: dict):
    """The port's ``EKFSlamConfig`` from a configuration file's fields."""
    from smarc_navigation_tpu_torch.configs import EKFSlamConfig

    names = {f.name for f in dataclasses.fields(EKFSlamConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in fields.items() if k in names}
    return EKFSlamConfig(**kw)


def timeline(tl: dict):
    """A navbench timeline dict (``traffic/timeline.py``) as the port's
    numpy-leaved ``Timeline``."""
    from smarc_navigation_tpu_torch.ops import timeline as T

    return T.Timeline(
        ticks=np.ascontiguousarray(tl["ticks"]), dt=tl["dt"],
        channels={n: T.Channel(**{k: np.ascontiguousarray(v) for k, v in c.items()})
                  for n, c in tl["channels"].items()},
        events={n: T.EventChannel(**{k: np.ascontiguousarray(v) for k, v in e.items()})
                for n, e in tl["events"].items()})


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Passed:
    def synchronize(self) -> None:
        pass


def marker(device):
    """A point in the device's stream after everything submitted so far:
    ``synchronize()`` waits until the device has passed it (on the CPU the
    work is done already)."""
    import torch

    if torch.device(device).type != "cuda":
        return _Passed()
    ev = torch.cuda.Event()
    ev.record()
    return ev
