"""The benchmark's reference: its mission-batched PyTorch form against the
frozen single-mission NumPy oracle, and its independence from both
navigation packages."""

import ast
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from navbench import manifest
from navbench.reference import ekf_slam_oracle as oracle
from navbench.reference import slam_fleet
from navbench.traffic import generate

FORBIDDEN = {"jax", "jaxlib", "flax", "smarc_navigation_tpu", "smarc_navigation_tpu_torch"}
REF_DIR = os.path.join(os.path.dirname(manifest.ROOT), "navbench", "reference")


def _small(config: str, L: int, T: int, n: int = 2, seed: int = 2**31 + 3):
    cfg = dict(manifest.config(config), max_landmarks=L)
    mix = manifest.mix("fleet1024")
    tl = generate.make(dict(mix, distinct=n, missions=n), cfg, seed)["distinct"]
    od, ev = tl["channels"]["odom"], tl["events"]["mbes"]
    return (cfg, od["value"][:, :T].astype(np.float64), od["valid"][:, :T],
            ev["value"][:, :T].astype(np.float64), ev["mask"][:, :T])


@pytest.mark.parametrize("config,L", [("slam-L64", 24), ("slam-L256", 16)])
def test_batched_reference_equals_single_mission_oracle(config, L):
    cfg, odom, valid, z, zmask = _small(config, L, T=90)
    rpy = slam_fleet.rpy_from_quat(torch.as_tensor(odom[..., 3:7])).numpy()
    pose6 = np.concatenate([odom[..., 0:3], rpy], -1)
    got = slam_fleet.replay(cfg, pose6, valid, z, zmask)
    for n in range(len(z)):
        ns = SimpleNamespace(**cfg)
        mus, matched, o = oracle.run_oracle(ns, dict(
            ticks=np.arange(z.shape[1]), odom_value=pose6[n], odom_valid=valid[n],
            det_value=z[n], det_mask=zmask[n]), "full")
        np.testing.assert_array_equal(got["matched"][n], matched)
        assert got["n_active"][n] == o.n_active and o.n_active >= 3
        np.testing.assert_allclose(got["pose"][n], mus, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["mu"][n], o.mu, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["Sigma"][n], o.Sigma, rtol=0, atol=1e-9)
    assert (got["matched"] >= 0).sum() > 20


def test_rpy_from_quat_inverts_the_generators_quaternion():
    rng = np.random.default_rng(1)
    rpy = rng.uniform([-0.5, -0.5, -3.1], [0.5, 0.5, 3.1], (50, 3))
    q = generate.quat_from_rpy_np(rpy)
    np.testing.assert_allclose(slam_fleet.rpy_from_quat(torch.as_tensor(q)).numpy(), rpy,
                               atol=1e-12)


def test_own_decisions_replayed_give_no_gap_and_the_same_run():
    cfg, odom, valid, z, zmask = _small("slam-L64", 64, T=60)
    free = slam_fleet.replay(cfg, odom, valid, z, zmask)
    forced = slam_fleet.replay(cfg, odom, valid, z, zmask, decisions=free["matched"])
    assert np.nanmax(forced["gap"]) <= 1e-12 and forced["overruled"].sum() == 0
    np.testing.assert_array_equal(forced["Sigma"], free["Sigma"])
    # one association moved to another landmark is overruled: the reference
    # keeps its own optimum, and the run's state is its own
    dec = free["matched"].copy()
    n, k, i = np.argwhere((dec >= 0) & (free["n_active_t"][:, :, None] >= 2))[-1]
    dec[n, k, i] = (dec[n, k, i] + 1) % free["n_active_t"][n, k]
    moved = slam_fleet.replay(cfg, odom, valid, z, zmask, decisions=dec)
    assert np.nanmax(moved["gap"]) > slam_fleet.TIE and moved["overruled"][n] == 1
    np.testing.assert_array_equal(moved["Sigma"], free["Sigma"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_imports_neither_package(name):
    bad = set(_imports(os.path.join(REF_DIR, name))) & FORBIDDEN
    assert not bad, f"{name} imports {bad}"
