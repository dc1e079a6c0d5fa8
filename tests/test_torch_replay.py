"""The port's chunked replay (``io.replay``): chunks against the unchunked
replay, resume from a checkpoint, the NaN guard, checkpoints interchanged
with the reference in both directions, and ``profile_replay``.

Everything here is bitwise: a chunk runs the same step on the same inputs
as the unchunked loop, and a checkpoint stores each leaf's bytes.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import DRConfig, EKFSlamConfig, SAMConfig
from smarc_navigation_tpu_torch.io import logs, replay, sim
from smarc_navigation_tpu_torch.models import dead_reckoning as dr
from smarc_navigation_tpu_torch.models import ekf_slam as slam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample_mission.npz")
CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=16, max_obs=8, mhl_dist_mbes=1.0,
                          q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)


def _bitwise(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _states_equal(a, b):
    return all(_bitwise(x, y) for x, y in zip(a, b))


def _slam_timeline(seconds, device):
    streams, _ = logs.load_log(SAMPLE)
    tl = logs.log_to_timeline(streams, CFG.system_freq, channels=("odom",),
                              events={"mbes": CFG.max_obs})
    n = int(round(seconds * CFG.system_freq)) + 1
    return tl.map(lambda x: x[:n]).to(device)


def _slam_step(params):
    def step(state, tick):
        return slam.step(CFG, params, state, tick)
    return step


def _dr():
    tl = dr.sam_timeline(sim.simulate(sim.MissionSpec(duration_s=30.0))).to("cpu")
    cfg, sam_cfg = DRConfig(), SAMConfig()

    def step(state, tick):
        return dr.dr_step(cfg, sam_cfg, state, tick)

    return tl, step, dr.dr_init(device="cpu")


@pytest.fixture(scope="module")
def slam_run():
    tl = _slam_timeline(12.0, "cpu")
    params = slam.make_params(CFG, device="cpu")
    final, out = slam.run(tl, params, CFG)
    return tl, params, final, out


def test_chunked_slam_bitwise_the_unchunked_run(slam_run, tmp_path):
    tl, params, final, out = slam_run
    s0 = slam.init_state(CFG, device="cpu")
    ck = str(tmp_path / "ck")
    got, got_out = replay.run_chunked(_slam_step(params), s0, tl, chunk_size=32,
                                      ckpt_dir=ck, ckpt_every_chunks=1)
    assert _states_equal(got, final)
    assert got_out.keys() == out.keys()
    for k in out:
        assert isinstance(got_out[k], np.ndarray) and _bitwise(got_out[k], out[k]), k
    # every chunk checkpointed, the last under the whole-chunk number
    assert sorted(os.listdir(ck)) == sorted(f"ckpt_{n}.npz" for n in (32, 64, 96, 128))
    assert replay.latest_checkpoint(ck).endswith("ckpt_128.npz")
    # the caller's state is never written
    assert _states_equal(s0, slam.init_state(CFG, device="cpu"))

    # resume from the middle checkpoint: the same tail, bit for bit
    mid = str(tmp_path / "mid")
    os.makedirs(mid)
    shutil.copy(os.path.join(ck, "ckpt_64.npz"), mid)
    fin2, tail = replay.run_chunked(_slam_step(params), s0, tl, chunk_size=32, ckpt_dir=mid)
    assert _states_equal(fin2, final)
    for k in out:
        assert _bitwise(tail[k], out[k][64:]), k
    # resumed past the end: nothing left to replay
    fin3, none = replay.run_chunked(_slam_step(params), s0, tl, chunk_size=32, ckpt_dir=ck)
    assert none is None and _states_equal(fin3, final)


def test_chunked_dr_and_nan_guard():
    tl, step, s0 = _dr()
    want = dr.run_sam_dr(tl)
    fin, out = replay.run_chunked(step, s0, tl, chunk_size=128)
    assert isinstance(out, np.ndarray) and _bitwise(out, want)
    assert fin.pos.shape == (3,)

    def bad_step(state, tick):
        state = state._replace(pos=state.pos / 0.0)
        return state, state.pos

    with pytest.raises(replay.ReplayError, match=r"non-finite filter state after chunk 0 "
                                                 r"\(ticks 0\.\.64\)"):
        replay.run_chunked(bad_step, s0, tl, chunk_size=64)
    replay.run_chunked(bad_step, s0, tl, chunk_size=64, validate=False)


def _jax_state(state_np, cls):
    import jax.numpy as jnp
    return cls(*(jnp.asarray(x) for x in state_np))


def test_checkpoints_interchange_with_the_reference(slam_run, tmp_path):
    """A checkpoint written by either package loads in the other, bitwise,
    for DRState and SlamState."""
    from smarc_navigation_tpu.io import replay as jreplay
    from smarc_navigation_tpu.models import dead_reckoning as jdr
    from smarc_navigation_tpu.models import ekf_slam as jslam

    _tl, _p, final, _out = slam_run
    tl, step, s0 = _dr()
    dr_state, _ = replay.run_chunked(step, s0, tl.map(lambda x: x[:50]), chunk_size=64)
    cases = ((final, jslam.SlamState, slam.init_state(CFG, device="cpu")),
             (dr_state, jdr.DRState, dr.dr_init(device="cpu")))
    for state, jcls, like in cases:
        port_path = str(tmp_path / f"port_{jcls.__name__}.npz")
        replay.save_checkpoint(port_path, state, 77)
        jstate, jtick = jreplay.load_checkpoint(
            port_path, _jax_state([x.numpy() for x in like], jcls))
        assert jtick == 77 and isinstance(jstate, jcls)
        assert all(_bitwise(np.asarray(a), b) for a, b in zip(jstate, state))

        ref_path = str(tmp_path / f"ref_{jcls.__name__}.npz")
        jreplay.save_checkpoint(ref_path, _jax_state([x.numpy() for x in state], jcls), 128)
        got, tick = replay.load_checkpoint(ref_path, like)
        assert tick == 128 and type(got) is type(like)
        assert _states_equal(got, state)
        assert all(g.device == w.device for g, w in zip(got, like))
    with pytest.raises(ValueError, match="leaves"):
        replay.load_checkpoint(str(tmp_path / "port_DRState.npz"), (torch.zeros(3),))


def test_profile_replay_writes_a_trace(tmp_path):
    tl, step, s0 = _dr()
    short = tl.map(lambda x: x[:20])
    fin, out = replay.profile_replay(step, s0, short, str(tmp_path / "trace"))
    assert _bitwise(out, dr.run_sam_dr(short))
    with open(tmp_path / "trace" / "replay_trace.json") as f:
        trace = json.load(f)
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.cuda
def test_chunked_slam_on_the_card_bitwise_run():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    tl = _slam_timeline(30.0, "cuda")
    params = slam.make_params(CFG, device="cuda")
    final, out = slam.run(tl, params, CFG)
    got, got_out = replay.run_chunked(_slam_step(params), slam.init_state(CFG, device="cuda"),
                                      tl, chunk_size=128)
    assert all(g.is_cuda for g in got)
    assert _states_equal(got, final)
    for k in out:
        assert _bitwise(got_out[k], out[k]), k
