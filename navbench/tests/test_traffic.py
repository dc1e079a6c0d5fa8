"""The frozen traffic generators (``navbench/traffic``) against checksums
recorded from the port's own generators when they were copied: a later
change to the port's simulator or timeline builders leaves the
benchmark's traffic as it is."""

import pytest

from navbench import manifest
from navbench.traffic import checksums, generate


def _made(what: str, seed: int):
    cfg = manifest.config("slam-L64")
    if what == "slam_mission":
        mix = manifest.mix("fleet1024")
        return generate.generator("slam_fleet").slam_mission_timeline(
            cfg, mix["duration_s"], seed, mix["mission"])
    mix = manifest.mix("online-lolo90")
    streams = generate.generator("lolo_log").lolo_log(mix, seed)
    if what == "lolo_log":
        return streams
    return generate.log_to_timeline(streams, cfg["system_freq"], ("odom",),
                                    {"mbes": cfg["max_obs"]})


@pytest.mark.parametrize("what,seed", checksums.CASES)
def test_frozen_generator_matches_recorded_checksum(what, seed):
    assert checksums.digest(_made(what, seed)) == checksums.load()[f"{what} {seed}"]


def test_seed_picks_missions():
    mix = manifest.mix("fleet1024")
    a, b = generate.mission_seeds(2**31 + 11, 16), generate.mission_seeds(-3, 16)
    assert a == generate.mission_seeds(2**31 + 11, 16) and a != b
    assert len(set(a)) == 16 and mix["distinct"] == 16
