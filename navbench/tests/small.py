"""Tiny sizes of each cell for the CPU tests: the cells' own
configurations and mixes, fewer missions and ticks."""

SIZES = {
    "fleet_replay": {"mix": {"missions": 2, "distinct": 2}, "T": 21},
    "online_step": {"mix": {"missions": 1}, "T": 120},
}


def sizes(cell: str) -> dict:
    from navbench import manifest

    return SIZES[manifest.workload(cell)["driver"]]
