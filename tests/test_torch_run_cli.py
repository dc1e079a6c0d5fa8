"""The port's mission CLI (``python -m smarc_navigation_tpu_torch.run``)
against the reference's ``run.main``: ``replay`` on the sample log cut to
its first 10 s (written with ``save_log``), ``demo --duration 5``, and
``pf`` at N=4096 over 5 s.

Tolerances: ``n_landmarks_mapped`` exact, the reports' pose metrics within
1e-3 (the same float32 filter in two frameworks over 101 and 51 ticks; the
libraries' sin, cos and atan2 differ in the last bits). ``pf`` cannot draw
JAX's random streams, so its report keys are held equal to the
reference's and its mean xy error under PF_ERR_M. The reference's CLI
runs twice in this file, in the module fixtures.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch import run
from smarc_navigation_tpu_torch.io import logs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample_mission.npz")
REF_RUN = os.path.join(REPO, "smarc_navigation_tpu", "run.py")
POSE_METRICS = ("rmse_pos", "rmse_att", "final_error", "path_length_est", "path_length_gt",
                "mean_error", "max_error")
# The pf mission's GPS fixes (std 0.3 m, 1 Hz, never diving) pull the bank
# to within a few GPS sigmas; 1 m is ~3 sigma of one fix, well above the
# 4096-particle filter's error on the 5 s mission and far below a lost
# filter's (the dead-reckoned spread grows without bound)
PF_ERR_M = 1.0


def _cut_log(path, seconds):
    streams, meta = logs.load_log(SAMPLE)
    base = min(s["stamps"][0] for s in streams.values() if len(s["stamps"]))
    cut = {}
    for name, s in streams.items():
        keep = s["stamps"] < base + seconds + 1e-9
        cut[name] = {k: v[keep] for k, v in s.items()}
    logs.save_log(path, cut, meta=dict(meta, cut_s=seconds))
    return path


def _ref_main(argv):
    """The reference CLI's printed JSON (everything before its 'wrote' line)."""
    from smarc_navigation_tpu import run as jrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrun.main(argv)
    text = buf.getvalue()
    return json.loads(text[:text.rindex("wrote")])


@pytest.fixture(scope="module")
def cut_log(tmp_path_factory):
    return _cut_log(str(tmp_path_factory.mktemp("log") / "cut10.npz"), 10.0)


@pytest.fixture(scope="module")
def ref_replay(cut_log, tmp_path_factory):
    return _ref_main(["replay", "--log", cut_log, "--out",
                      str(tmp_path_factory.mktemp("ref_replay"))])


@pytest.fixture(scope="module")
def ref_demo(tmp_path_factory):
    return _ref_main(["demo", "--duration", "5", "--out",
                      str(tmp_path_factory.mktemp("ref_demo"))])


def _close_reports(got, want):
    assert got["n_landmarks_mapped"] == want["n_landmarks_mapped"]
    for k in POSE_METRICS:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_replay_matches_reference(cut_log, ref_replay, tmp_path):
    out = str(tmp_path / "rep")
    rep = run.main(["replay", "--log", cut_log, "--out", out, "--device", "cpu"])
    assert rep.keys() == ref_replay.keys()
    _close_reports(rep, ref_replay)
    assert rep["ticks"] == ref_replay["ticks"] == 101
    assert rep["event_stats"] == ref_replay["event_stats"]
    assert rep["meta"] == ref_replay["meta"] and rep["log"] == cut_log
    assert json.load(open(os.path.join(out, "report.json"))) == json.loads(
        json.dumps(rep, default=str))


def test_replay_without_ground_truth(cut_log, tmp_path):
    streams, meta = logs.load_log(cut_log)
    del streams["gt"]
    path = str(tmp_path / "nogt.npz")
    logs.save_log(path, streams, meta=meta)
    rep = run.main(["replay", "--log", path, "--out", str(tmp_path / "o"), "--device", "cpu"])
    assert len(rep["final_pose"]) == 6 and "rmse_pos" not in rep
    with pytest.raises(SystemExit, match="no 'odom' stream"):
        del streams["odom"]
        logs.save_log(path, streams, meta=meta)
        run.main(["replay", "--log", path, "--out", str(tmp_path / "o"), "--device", "cpu"])


def test_demo_matches_reference(ref_demo, tmp_path):
    out = str(tmp_path / "demo")
    got = run.main(["demo", "--duration", "5", "--out", out, "--device", "cpu"])
    assert got.keys() == ref_demo.keys() == {"stats", "report"}
    assert got["report"].keys() == ref_demo["report"].keys()
    _close_reports(got["report"], ref_demo["report"])
    assert got["stats"].keys() == ref_demo["stats"].keys()
    for name, st in got["stats"].items():
        for k, v in st.items():
            assert abs(v - ref_demo["stats"][name][k]) <= 1e-3, (name, k)
    assert os.path.exists(os.path.join(out, "report.json"))


def _ref_pf_keys():
    """The keys of the report dict the reference's ``_pf`` prints."""
    tree = ast.parse(open(REF_RUN).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "_pf")
    d = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict))
    return [k.value for k in d.keys]


@pytest.mark.parametrize("pallas", [False, True])
def test_pf_report(pallas, capsys):
    argv = ["pf", "--duration", "5", "--particles", "4096", "--device", "cpu"]
    rep = run.main(argv + (["--pallas"] if pallas else []))
    assert list(rep) == _ref_pf_keys()
    assert rep["particles"] == 4096 and rep["ticks"] == 51
    assert np.isfinite(rep["xy_err_mean_m"]) and rep["xy_err_mean_m"] < PF_ERR_M, rep
    assert json.loads(capsys.readouterr().out) == rep


def _arguments(path, prog_fn):
    """{(subcommand, flag): default} of the CLI's argparse calls, read from
    the module's source."""
    tree = ast.parse(open(path).read())
    main = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == prog_fn)
    subs, out = {}, {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and getattr(
                node.value.func, "attr", "") == "add_parser":
            subs[node.targets[0].id] = node.value.args[0].value
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            owner = node.func.value.id
            default = next((ast.literal_eval(k.value) for k in node.keywords
                            if k.arg == "default"), None)
            for sub in ([subs[owner]] if owner in subs else subs.values()):
                out[(sub, node.args[0].value)] = default
    return out


def test_cli_arguments_are_the_reference_plus_device():
    want = _arguments(REF_RUN, "main")
    got = _arguments(run.__file__, "main")
    assert {k: v for k, v in got.items() if k[1] != "--device"} == want
    assert {k for k in got if k[1] == "--device"} == {(c, "--device") for c in
                                                     ("demo", "replay", "pf")}
    assert all(got[(c, "--device")] == "cuda" for c in ("demo", "replay", "pf"))


def test_cli_defaults_to_the_card_and_raises_without_one(cut_log, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["replay", "--log", cut_log], ["demo", "--duration", "1"],
                 ["pf", "--duration", "1", "--particles", "64"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(argv + ["--out", str(tmp_path)] if argv[0] != "pf" else argv)


def test_module_entry_point(cut_log, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "smarc_navigation_tpu_torch.run", "replay", "--log", cut_log,
         "--out", str(tmp_path / "m"), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout[:proc.stdout.rindex("wrote")])["ticks"] == 101
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "smarc_navigation_tpu_torch.run", "replay", "--log",
             cut_log, "--out", str(tmp_path / "m")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
