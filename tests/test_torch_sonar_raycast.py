"""Sonar perception and MBES ray casting (``ops/sonar.py``, ``ops/raycast.py``)
against the JAX package's on the same inputs.

Tolerances: the discrete outputs are exact: detection masks and beams (so
the detected points' ranges), blob masks, areas and centroids, connected
component labels, rendered intensities. Floats: detected points within
1e-5 m (the same range times the same f32 cos/sin), box blur within 1e-6,
fused submaps within 1e-5 m, rendered ranges (and the detected points)
within 2e-5 of the range (the beam angles are the f64 linspace rounded to
f32, the reference's f32 arithmetic: an ulp apart in places, which a
slanted beam's floor range amplifies; observed 7.7e-6).
The scans reuse ``tests/test_sonar.py``'s shapes and the raycast scans
``tests/test_slam_fleet.py``'s raycast case (32 beams, 8 rocks, the seed-1
mission).
"""

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.ops import raycast, sonar

SPEC = dict(num_beams=32, floor_z=-16.0, rock_radius=1.2, swath_rad=2.4, max_range=40.0)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.ops import raycast as jr
    from smarc_navigation_tpu.ops import sonar as js

    return dict(jax=jax, jnp=jnp, sim=jsim, raycast=jr, sonar=js)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def make_scan(n=128, peaks=((40, 8.0), (90, 12.0)), width=4, base=1.0, amp=10.0):
    intens = np.full(n, base)
    ranges = np.full(n, 20.0)
    for beam, rng in peaks:
        intens[beam - width // 2:beam + width // 2 + 1] += amp
        ranges[beam - width // 2:beam + width // 2 + 1] = rng
    return intens.astype(np.float32), ranges.astype(np.float32)


def _random_scans(seed, count, n=128):
    """``tests/test_sonar.py``'s oracle scans: uniform noise with three hot
    runs of 2-4 beams."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        intens = rng.uniform(0, 1, n)
        for h in rng.choice(np.arange(4, n - 4), 3, replace=False):
            intens[h:h + rng.integers(2, 5)] += 8.0
        out.append((intens.astype(np.float32), rng.uniform(5, 30, n).astype(np.float32)))
    return out


def _assert_dets(got, want, what=""):
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask)), what
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_peaks_matches_jax_on_random_scans(jx, seed):
    scans = _random_scans(seed, 20)
    for i, (intens, ranges) in enumerate(scans):
        got = sonar.extract_peaks(_t(intens), _t(ranges), -1.0, 0.01, 50.0, max_detections=8)
        want = jx["sonar"].extract_peaks(jx["jnp"].asarray(intens), jx["jnp"].asarray(ranges),
                                        -1.0, 0.01, 50.0, max_detections=8)
        _assert_dets(got, want, f"scan {i}")
    # the same scans as one batch: each row is its own scan
    I = _t(np.stack([s[0] for s in scans]))
    R = _t(np.stack([s[1] for s in scans]))
    batched = sonar.extract_peaks(I, R, -1.0, 0.01, 50.0, max_detections=8)
    for i in range(len(scans)):
        one = sonar.extract_peaks(I[i], R[i], -1.0, 0.01, 50.0, max_detections=8)
        assert torch.equal(batched.mask[i], one.mask) and torch.equal(batched.points[i], one.points)


@pytest.mark.parametrize("case", ["two_clusters", "flat", "spike", "few_slots"])
def test_extract_peaks_edge_cases_match_jax(jx, case):
    if case == "flat":
        intens, ranges = np.full(128, 5.0, np.float32), np.full(128, 20.0, np.float32)
    elif case == "spike":
        intens, ranges = np.ones(128, np.float32), np.full(128, 10.0, np.float32)
        intens[60] = 100.0
    else:
        intens, ranges = make_scan(peaks=((10, 5.0), (40, 8.0), (70, 11.0), (90, 12.0)))
    k = 2 if case == "few_slots" else 8
    got = sonar.extract_peaks(_t(intens), _t(ranges), -1.0, 2.0 / 128, 50.0, max_detections=k)
    want = jx["sonar"].extract_peaks(jx["jnp"].asarray(intens), jx["jnp"].asarray(ranges),
                                    -1.0, 2.0 / 128, 50.0, max_detections=k)
    _assert_dets(got, want, case)
    n = {"two_clusters": 4, "flat": 0, "spike": 1, "few_slots": 2}[case]
    assert int(got.mask.sum()) == n


def test_smoothing_threshold_and_scans_to_base_match_jax(jx):
    jnp = jx["jnp"]
    intens, ranges = make_scan()
    sm = sonar.smooth_intensities(_t(intens))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jx["sonar"].smooth_intensities(
        jnp.asarray(intens))))
    assert float(sonar.adaptive_threshold(sm, 50.0)) == float(jx["sonar"].adaptive_threshold(
        jnp.asarray(sm.numpy()), jnp.float32(50.0)))
    det = sonar.extract_peaks(_t(intens), _t(ranges), -1.0, 2.0 / 128, 50.0)
    jdet = jx["sonar"].extract_peaks(jnp.asarray(intens), jnp.asarray(ranges), -1.0, 2.0 / 128,
                                    50.0)
    rot = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    t_l, t_r = np.asarray([0.0, 1.0, 0.0], np.float32), np.asarray([0.5, -1.0, 0.2], np.float32)
    got = sonar.scans_to_base(det, det, _t(rot), _t(t_l), torch.eye(3), _t(t_r))
    want = jx["sonar"].scans_to_base(jdet, jdet, jnp.asarray(rot), jnp.asarray(t_l),
                                     jnp.eye(3), jnp.asarray(t_r))
    _assert_dets(got, want)
    assert int(got.mask.sum()) == 4


def _blob_images():
    a = np.zeros((128, 128), np.float32)
    a[30:65, 40:75] += 1.0      # ~1225 px blob
    a[90:100, 90:100] += 1.0    # 100 px blob (below min_area)
    H = W = 120
    yy, xx = np.mgrid[0:H, 0:W]
    b = np.zeros((H, W), np.float32)
    b[(yy - 35) ** 2 + (xx - 35) ** 2 <= 15 ** 2] = 1.0     # disc
    b[80:86, 5:115] = 1.0                                   # 6x110 bar
    return {"two_squares": (a, {}),
            "disc_and_bar": (b, dict(min_area=300, max_area=2000, max_blobs=4,
                                     min_circularity=0.0)),
            "disc_and_bar_strict": (b, dict(min_area=300, max_area=2000, max_blobs=4,
                                            min_circularity=0.5))}


@pytest.mark.parametrize("name", list(_blob_images()))
def test_detect_blobs_matches_jax_exactly(jx, name):
    img, kw = _blob_images()[name]
    cent, area, mask = sonar.detect_blobs(_t(img), threshold=0.5, **kw)
    jc, ja, jm = jx["sonar"].detect_blobs(jx["jnp"].asarray(img), threshold=0.5, **kw)
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    assert np.array_equal(area.numpy(), np.asarray(ja))
    assert np.array_equal(cent.numpy(), np.asarray(jc))
    assert int(mask.sum()) == {"two_squares": 1, "disc_and_bar": 2, "disc_and_bar_strict": 1}[name]
    fls = sonar.blobs_to_fls_frame(cent, *img.shape)
    np.testing.assert_array_equal(fls.numpy(), np.asarray(
        jx["sonar"].blobs_to_fls_frame(jc, *img.shape)))
    # a batch of images: each its own result
    c2, a2, m2 = sonar.detect_blobs(torch.stack([_t(img), _t(img[::-1].copy())]), threshold=0.5,
                                    **kw)
    assert torch.equal(c2[0], cent) and torch.equal(a2[0], area) and torch.equal(m2[0], mask)
    c1, a1, m1 = sonar.detect_blobs(_t(img[::-1].copy()), threshold=0.5, **kw)
    assert torch.equal(c2[1], c1) and torch.equal(a2[1], a1) and torch.equal(m2[1], m1)


def test_box_blur_and_components_match_jax(jx):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (40, 56)).astype(np.float32)
    np.testing.assert_allclose(sonar.box_blur(_t(img), 5).numpy(),
                               np.asarray(jx["sonar"].box_blur(jx["jnp"].asarray(img), 5)),
                               rtol=0, atol=1e-6)
    mask = rng.uniform(0, 1, (40, 56)) > 0.45
    got = sonar.connected_components(_t(mask), 24)
    want = jx["sonar"].connected_components(jx["jnp"].asarray(mask), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fuse_submap_and_save_pcd_match_jax(jx, tmp_path):
    jnp = jx["jnp"]
    rng = np.random.default_rng(1)
    P, B = 5, 16
    pts = rng.normal(size=(P, B, 3)).astype(np.float32)
    mask = rng.uniform(size=(P, B)) > 0.2
    ang = rng.uniform(-0.5, 0.5, P)
    rot = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                    for a in ang]).astype(np.float32)
    trans = rng.normal(size=(P, 3)).astype(np.float32)
    got, gm = sonar.fuse_submap(_t(pts), _t(mask), _t(rot), _t(trans))
    want, wm = jx["sonar"].fuse_submap(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rot),
                                       jnp.asarray(trans))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    vq = np.asarray([0.0, 0.0, 0.38268343, 0.92387953])
    n = sonar.save_pcd(str(tmp_path / "port" / "sub.pcd"), got, gm, trans[2], vq)
    jn = jx["sonar"].save_pcd(str(tmp_path / "jax" / "sub.pcd"), np.asarray(got), np.asarray(gm),
                              trans[2], vq)
    assert n == jn == int(mask.sum())
    assert (tmp_path / "port" / "sub.pcd").read_text() == (tmp_path / "jax" / "sub.pcd").read_text()


@pytest.fixture(scope="module")
def pings(jx):
    """The raycast case's inputs: the seed-1 mission's first 40 poses at
    10 Hz and 8 rocks from ``default_rng(0)``, for both packages."""
    m = jx["sim"].simulate(jx["sim"].MissionSpec(duration_s=10.0, seed=1))
    gt = m.gt_at(np.arange(40) / 10.0).astype(np.float32)
    rng = np.random.default_rng(0)
    lms = rng.uniform([0, -20, -16], [40, 20, -12], (8, 3)).astype(np.float32)
    lmm = np.ones(8, bool)
    lmm[5] = False
    return gt, lms, lmm


def test_beam_dirs_match_jax(jx):
    got = raycast.beam_dirs_base(raycast.MBESSpec(**SPEC), device="cpu")
    want = np.asarray(jx["raycast"].beam_dirs_base(jx["raycast"].MBESSpec(**SPEC)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=1).numpy(), 1.0, atol=1e-6)


def test_render_and_detections_match_jax(jx, pings):
    jnp, jr = jx["jnp"], jx["raycast"]
    gt, lms, lmm = pings
    spec, jspec = raycast.MBESSpec(**SPEC), jr.MBESSpec(**SPEC)
    T = gt.shape[0]
    # all 40 pings as one batch of missions, each with the same rock field
    rngs, intens = raycast.render_ping(_t(gt), _t(lms).expand(T, 8, 3), _t(lmm).expand(T, 8),
                                       spec)
    pts, mask = raycast.ping_detections(_t(gt), _t(lms).expand(T, 8, 3), _t(lmm).expand(T, 8),
                                        spec, max_detections=4)
    n_rock = n_det = 0
    for t in range(T):
        jrng, jint = jr.render_ping(jnp.asarray(gt[t]), jnp.asarray(lms), jnp.asarray(lmm), jspec)
        np.testing.assert_array_equal(intens[t].numpy(), np.asarray(jint), err_msg=f"ping {t}")
        np.testing.assert_allclose(rngs[t].numpy(), np.asarray(jrng), rtol=2e-5, atol=0)
        jp, jm = jr.ping_detections(jnp.asarray(gt[t]), jnp.asarray(lms), jnp.asarray(lmm), jspec,
                                    max_detections=4)
        np.testing.assert_array_equal(mask[t].numpy(), np.asarray(jm), err_msg=f"ping {t}")
        np.testing.assert_allclose(pts[t].numpy(), np.asarray(jp), rtol=0,
                                   atol=2e-5 * spec.max_range)
        one = raycast.ping_detections(_t(gt[t]), _t(lms), _t(lmm), spec, max_detections=4)
        assert torch.equal(one[1], mask[t]) and torch.equal(one[0], pts[t])
        n_rock += int((intens[t] == spec.rock_intensity).sum())
        n_det += int(mask[t].sum())
    assert n_rock > 0 and n_det > 0      # the case exercises rock hits and detections


def test_no_rocks_sees_the_floor_only():
    spec = raycast.MBESSpec()
    pose = torch.tensor([0.0, 0.0, -5.0, 0.0, 0.0, 0.0])
    rng, intens = raycast.render_ping(pose, torch.zeros(3, 3), torch.zeros(3, dtype=torch.bool),
                                      spec)
    assert torch.all(intens == spec.base_intensity)
    # straight down the range is the depth to the floor
    assert abs(float(rng[spec.num_beams // 2]) - 10.0) < 0.1
    _, mask = raycast.ping_detections(pose, torch.zeros(3, 3), torch.zeros(3, dtype=torch.bool),
                                      spec)
    assert not bool(mask.any())
