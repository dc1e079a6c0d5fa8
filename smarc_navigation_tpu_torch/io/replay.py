"""Chunked mission replay with checkpoint/resume and health guards (port of
``smarc_navigation_tpu/io/replay.py``).

The reference has no checkpointing at all — estimator state lives in node
memory and persistence means rosbag recording (SURVEY.md §5). Here replays
of arbitrarily long missions run as a sequence of chunks, each a loop of
``step_fn`` over its ticks on the device of the timeline's tensors; filter
state snapshots to disk every K chunks and replays resume from the latest
snapshot. A NaN/health guard runs once per chunk (one host sync) — the
dropout masks in the timeline are the fault-injection mechanism, this is
the detection side.

Checkpoints keep the reference's npz layout: ``tick_idx``, ``n_leaves`` and
``leaf_{i}``, the state's leaves in NamedTuple field order (dict entries in
sorted key order), which is the order JAX flattens them in — so a
checkpoint written by either package loads in the other for the same state
type (``DRState``, ``SlamState``).

One difference from the reference: its chunks are one compiled ``lax.scan``
shape, so it pads the timeline to whole chunks and scans the pad ticks
(copies of the last tick) into its final state, trimming only their
outputs. Here a chunk is a loop, so the last chunk stops at the last tick:
the final state and the outputs are those of the unchunked replay, bit for
bit. Checkpoint names and ``tick_idx`` keep the reference's whole-chunk
numbering, so resuming past the end finds nothing left to replay in
either package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.timeline import Timeline


class ReplayError(RuntimeError):
    pass


def _flatten(tree) -> list:
    """Leaves of a state/output tree: tuples and NamedTuples in field order,
    dicts in sorted key order (JAX's flattening order), anything else a
    leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(path: str, state, tick_idx: int) -> None:
    leaves = _flatten(state)
    np.savez(
        path,
        tick_idx=tick_idx,
        n_leaves=len(leaves),
        **{f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)},
    )


def load_checkpoint(path: str, state_like):
    """(state, tick_idx) from a checkpoint: each leaf on the device and with
    the dtype of ``state_like``'s leaf."""
    data = np.load(path)
    leaves_like = _flatten(state_like)
    n = int(data["n_leaves"])
    if n != len(leaves_like):
        raise ValueError(f"checkpoint {path!r} holds {n} leaves, the state {len(leaves_like)}")
    leaves = [
        torch.as_tensor(data[f"leaf_{i}"]).to(device=like.device, dtype=like.dtype)
        for i, like in enumerate(leaves_like)
    ]
    return _unflatten(state_like, iter(leaves)), int(data["tick_idx"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(
        (f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_") and f.endswith(".npz")),
        key=lambda f: int(f.split("_")[1].split(".")[0]),
    )
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


def _finite(state) -> bool:
    """Whether every floating leaf of the state is finite: one host sync."""
    flags = [torch.isfinite(x).all() for x in _flatten(state)
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack([f.to(flags[0].device) for f in flags]).all())


def _stack_host(outs: list):
    """Per-tick outputs of one chunk -> the same structure with each leaf
    stacked over the chunk's ticks as host numpy."""
    per_tick = [_flatten(o) for o in outs]
    stacked = [torch.stack([leaves[i] for leaves in per_tick]).cpu().numpy()
               for i in range(len(per_tick[0]))]
    return _unflatten(outs[0], iter(stacked))


def run_chunked(
    step_fn: Callable,          # (state, tick) -> (state, out)
    state0,
    timeline: Timeline,
    chunk_size: int = 512,
    ckpt_dir: Optional[str] = None,
    ckpt_every_chunks: int = 4,
    validate: bool = True,
    resume: bool = True,
):
    """Replay a tensor-leaved ``timeline`` through ``step_fn`` in chunks.

    Returns (final_state, outs) where outs leaves are host numpy arrays
    stacked over the replayed ticks (all T, or those after the checkpoint a
    replay resumed from; None when it resumed past the end). ``state0`` is
    cloned: the caller's tensors are never written."""
    T = timeline.num_ticks
    n_chunks = -(-T // chunk_size)

    state = _unflatten(state0, iter(
        x.clone() if isinstance(x, torch.Tensor) else x for x in _flatten(state0)))
    start_chunk = 0
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        if resume:
            ck = latest_checkpoint(ckpt_dir)
            if ck:
                state, tick_idx = load_checkpoint(ck, state0)
                start_chunk = tick_idx // chunk_size

    outs = []
    for c in range(start_chunk, n_chunks):
        chunk = []
        for k in range(c * chunk_size, min((c + 1) * chunk_size, T)):
            state, out = step_fn(state, timeline.slice_tick(k))
            chunk.append(out)
        if validate and not _finite(state):
            raise ReplayError(
                f"non-finite filter state after chunk {c} "
                f"(ticks {c * chunk_size}..{(c + 1) * chunk_size})"
            )
        outs.append(_stack_host(chunk))
        if ckpt_dir and ((c + 1) % ckpt_every_chunks == 0 or c == n_chunks - 1):
            save_checkpoint(
                os.path.join(ckpt_dir, f"ckpt_{(c + 1) * chunk_size}.npz"),
                state,
                (c + 1) * chunk_size,
            )

    if not outs:  # resumed past the end: nothing left to replay
        return state, None
    merged = [np.concatenate(xs, axis=0) for xs in zip(*(_flatten(o) for o in outs))]
    return state, _unflatten(outs[0], iter(merged))


def profile_replay(step_fn, state0, timeline: Timeline, trace_dir: str):
    """A replay under ``torch.profiler`` (host and, where the timeline is on
    a CUDA device, device activity); the Chrome trace is written to
    ``trace_dir/replay_trace.json`` (SURVEY §5 'tracing/profiling': the
    reference had only ROS_INFO prints)."""
    from torch.profiler import ProfilerActivity, profile

    on_cuda = timeline.ticks.is_cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        final, out = run_chunked(step_fn, state0, timeline, ckpt_dir=None, validate=False)
        if on_cuda:
            torch.cuda.synchronize(timeline.ticks.device)
    prof.export_chrome_trace(os.path.join(trace_dir, "replay_trace.json"))
    return final, out
