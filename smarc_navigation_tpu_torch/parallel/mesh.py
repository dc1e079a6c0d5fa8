"""Device mesh, sharding helpers and the explicit collectives (PyTorch port
of ``smarc_navigation_tpu/parallel/mesh.py``).

The reference's mesh is a grid of ``jax.devices()`` driven by one
controller through ``shard_map``; so is this one. A ``Mesh`` holds a
(mission, particle) grid of ``torch.device``s, and one Python process
drives every shard in turn: a shard is a tensor on its grid cell's device,
and a shard body is a sequence of stages over the list of shards, in shard
order. A device may repeat in the grid, so four shards can share one card
(``make_mesh(particle=4, devices=[torch.device("cuda")] * 4)``) or eight
the CPU (the tests); on a machine with four cards ``make_mesh()`` places
them on ``cuda:0..3`` and the collectives copy between cards.

Axes: ``mission`` (independent missions of a fleet) and ``particle`` (one
mission's particle bank split into contiguous column shards).

The sharding helpers split a tensor (or a tree of tensors) into its
per-shard pieces on their devices and join pieces back; the collectives
(``all_gather``, ``psum``, ``pmax``, ``from_left``, ``from_right``) take a
list of per-shard tensors in shard order and return one result per shard,
placed on that shard's device (``_to``: a copy to a card does not block the
host; one to the CPU does, so its result is complete when it returns). No
``torch.distributed``: every shard lives in this process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

MISSION_AXIS = "mission"
PARTICLE_AXIS = "particle"


def _device(d) -> torch.device:
    """A device with its ordinal: ``cuda`` is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: no copy where it lies there already; a copy to a
    card is queued on its stream (``non_blocking``), one to the CPU waits
    for its data."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


class Mesh:
    """A (mission, particle) grid of devices. ``shape[MISSION_AXIS]`` and
    ``shape[PARTICLE_AXIS]`` are its sizes, ``devices[m][p]`` its cells."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[_device(d) for d in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.shape = {MISSION_AXIS: len(self.devices), PARTICLE_AXIS: widths.pop()}

    def row(self, m: int) -> "Mesh":
        """The 1 x particle mesh of mission shard ``m``."""
        return Mesh([self.devices[m]])

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices})"


def make_mesh(
    mission: Optional[int] = None,
    particle: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over ``devices`` (default: every CUDA device; it raises where
    there is none, and never falls back to the CPU): a (mission, particle)
    grid, by default all devices on the mission axis. A device may repeat:
    ``devices=[torch.device("cpu")] * 8`` is eight shards on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. CPU devices)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if mission is None:
        mission = n // particle
    if mission * particle != n:
        raise ValueError(f"mesh {mission}x{particle} != {n} devices")
    return Mesh([devices[m * particle:(m + 1) * particle] for m in range(mission)])


# ---------------------------------------------------------------------------
# sharding: which tensor dimension splits over which mesh axis
# ---------------------------------------------------------------------------

class Sharding(NamedTuple):
    """A tensor's layout over a mesh, as the reference's ``NamedSharding``:
    ``spec[d]`` is the mesh axis dimension d splits over (contiguous equal
    pieces), or None (the piece holds all of it)."""

    mesh: Mesh
    spec: tuple

    def _split(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None

    def shard(self, x: torch.Tensor) -> list:
        """Per-shard pieces of ``x``, ``[m][p]``, each on its cell's device
        (a copy only where the device differs)."""
        out = []
        for m, row in enumerate(self.mesh.devices):
            out.append([_to(self._piece(x, m, p), d) for p, d in enumerate(row)])
        return out

    def _piece(self, x, m, p):
        for axis, i in ((MISSION_AXIS, m), (PARTICLE_AXIS, p)):
            dim = self._split(axis)
            if dim is not None:
                size = self.mesh.shape[axis]
                if x.shape[dim] % size:
                    raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split "
                                     f"over {size} {axis} shards")
                w = x.shape[dim] // size
                x = x.narrow(dim, i * w, w)
        return x.contiguous()

    def join(self, pieces, device) -> torch.Tensor:
        """The tensor of per-shard pieces ``[m][p]``, on ``device``: pieces
        concatenated along each split dimension; of the copies along an axis
        the tensor does not split over, the first."""
        rows = []
        for row in pieces:
            dim = self._split(PARTICLE_AXIS)
            parts = [_to(t, device) for t in row]
            rows.append(torch.cat(parts, dim) if dim is not None else parts[0])
        dim = self._split(MISSION_AXIS)
        return torch.cat(rows, dim) if dim is not None else rows[0]


def mission_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Batch-of-missions arrays: leading axis split over ``mission``."""
    return Sharding(mesh, (MISSION_AXIS,) + (None,) * (ndim - 1))


def particle_sharding(mesh: Mesh, ndim: int, particle_axis: int = 0) -> Sharding:
    spec = [None] * ndim
    spec[particle_axis] = PARTICLE_AXIS
    return Sharding(mesh, tuple(spec))


def mission_particle_sharding(mesh: Mesh, ndim: int, particle_axis: int = 1) -> Sharding:
    """Fleet particle banks: leading mission axis + a particle axis
    (default axis 1; the PF's (B, 6, N) layout passes particle_axis=2)."""
    spec = [None] * ndim
    spec[0] = MISSION_AXIS
    spec[particle_axis] = PARTICLE_AXIS
    return Sharding(mesh, tuple(spec))


def tree_map(fn, tree):
    """``fn`` over every tensor of a tree (tensors, dicts, lists, tuples,
    NamedTuples, timeline containers with ``.map``; None and other leaves
    stay as they are)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if hasattr(tree, "map"):
        return tree.map(lambda x: tree_map(fn, x))
    return tree


def shard_missions(tree, mesh: Mesh) -> list:
    """Every tensor's leading axis split over the mission axis: one tree per
    mission shard, on the first device of its mesh row (the shard's copies
    along the particle axis would hold the same values)."""
    return [tree_map(lambda x, m=m: _to(mission_sharding(mesh, x.dim())._piece(x, m, 0),
                                        mesh.devices[m][0]), tree)
            for m in range(mesh.shape[MISSION_AXIS])]


def replicate(tree, mesh: Mesh) -> list:
    """The tree on every device of the mesh, one copy per cell, in row-major
    (mission, particle) order (no copy where the device is the tree's)."""
    return [tree_map(lambda x, d=d: _to(x, d), tree)
            for row in mesh.devices for d in row]


def join_missions(trees: Sequence, device, axis: int = 0):
    """Per-mission-shard trees (as ``shard_missions`` gives them) joined
    along ``axis`` on ``device``."""
    flat = [_leaves(t) for t in trees]
    joined = iter([torch.cat([_to(x, device) for x in xs], axis)
                   for xs in zip(*flat)])
    return tree_map(lambda _x: next(joined), trees[0])


def _leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


# ---------------------------------------------------------------------------
# the collectives of the shard bodies, over per-shard tensors in shard order
# ---------------------------------------------------------------------------

def _on(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return _to(x, like.device)


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = True, axis: int = 0) -> list:
    """Every shard's tensor concatenated (``tiled``) or stacked along
    ``axis``, in shard order, on each shard's device."""
    dev0 = xs[0].device
    cat = (torch.cat if tiled else torch.stack)([_to(x, dev0) for x in xs], axis)
    return [_on(cat, x) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> list:
    """The sum of the shards' tensors, added in shard order, on each shard's
    device."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + _on(x, acc)
    return [_on(acc, x) for x in xs]


def pmax(xs: Sequence[torch.Tensor]) -> list:
    """The elementwise max over the shards' tensors, on each shard's device."""
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, _on(x, acc))
    return [_on(acc, x) for x in xs]


def from_left(xs: Sequence[torch.Tensor]) -> list:
    """Each shard receives its LEFT neighbour's tensor (shard 0: zeros)."""
    return [torch.zeros_like(xs[0])] + [_on(xs[s - 1], xs[s]) for s in range(1, len(xs))]


def from_right(xs: Sequence[torch.Tensor]) -> list:
    """Each shard receives its RIGHT neighbour's tensor (the last: zeros)."""
    return [_on(xs[s + 1], xs[s]) for s in range(len(xs) - 1)] + [torch.zeros_like(xs[-1])]
