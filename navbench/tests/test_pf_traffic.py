"""The frozen PF mission generator (``navbench/traffic/generators/
pf_mission.py``) against checksums recorded from the port's own mission
(``io/sim`` and ``models/particle_filter.pf_timeline``, with the
``gps1hz`` mix's mission) when the copy was made
(``navbench/traffic/pf_checksums.json``): a later change to the port's
simulator or ``pf_timeline`` leaves the cell's traffic as it is."""

import json
import os

import numpy as np
import pytest

from navbench import manifest
from navbench.traffic import checksums, generate

FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic",
                    "pf_checksums.json")
with open(FILE) as f:
    RECORDED = json.load(f)


@pytest.mark.parametrize("key", sorted(RECORDED))
def test_frozen_pf_generator_matches_recorded_checksum(key):
    seed = int(key.split()[1])
    mix = manifest.mix("gps1hz")
    tl = generate.generator("pf_mission").pf_mission_timeline(
        mix["duration_s"], seed, mix["mission"], mix["odom_hz"])
    assert checksums.digest(tl) == RECORDED[key]


def test_mix_gives_the_cells_mission():
    mix = manifest.mix("gps1hz")
    gen = generate.make(mix, manifest.config("pf-1M"), 2**31 + 11)
    tl = gen["distinct"]
    upd = tl["channels"]["gps"]["fresh"] & (tl["channels"]["diving"]["value"][..., 0] < 0.5)
    assert tl["ticks"].shape == (16, 601) and len(set(gen["seeds"])) == 16
    assert (upd.sum(1) == 60).all() and np.array_equal(np.nonzero(upd[0])[0], np.arange(10, 601, 10))
