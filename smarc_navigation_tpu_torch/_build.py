"""Builder and loader of the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>.so``, then loaded with
``ctypes``. The build runs at first use, from the sources in the package
only, and again whenever a source's sha256 (or its flags) changes — the
library's ``.srchash`` stamp records what it was built from (the source,
the shared ``csrc/*.cuh`` headers and the flags), never its mtime (a
checkout gives every file the same mtime). ``build_all`` starts one
``nvcc`` per source at once and waits for all. ``nvcc``'s resource
report (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-library extra flags: the DA kernel's gate/cost arithmetic, the online
# predict's pose and Jacobian, the PF kernels' motion, jitter, generator and
# GPS-weight arithmetic and the two filter tick kernels round every product
# (no FMA contraction), like the plain PyTorch versions' elementwise ops
EXTRA_FLAGS = {"slam_da": ["-fmad=false"], "slam_update": [], "slam_downdate": [],
               "slam_marginal": [], "slam_predict": ["-fmad=false"],
               "pf_predict": ["-fmad=false"],
               "pf_resample": ["-fmad=false"], "pf_update": ["-fmad=false"],
               "loc_tick": ["-fmad=false"],
               "ekf15_tick": ["-fmad=false"]}

_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
        "is installed (PATH or /usr/local/cuda/bin)")


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, *BASE_FLAGS, *EXTRA_FLAGS[name],
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _src_hash(name: str) -> str:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS[name]).encode())
    return h.hexdigest()


def _start(name: str):
    """Start compiling ``csrc/<name>.cu`` unless the cached library matches
    its source hash: None when cached, else (process, tmp path, lib, stamp,
    hash)."""
    lib = BUILD / f"lib{name}.so"
    stamp = BUILD / f"lib{name}.so.srchash"
    want = _src_hash(name)
    if lib.exists() and stamp.exists() and stamp.read_text().strip() == want:
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, lib, stamp, want


def _finish(name: str, job) -> Path:
    proc, tmp, lib, stamp, want = job
    out, err = proc.communicate()
    (BUILD / f"lib{name}.log").write_text(out + err)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{err}")
    os.replace(tmp, lib)
    stamp.write_text(want)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the cached library matches its
    source hash; returns the library path."""
    job = _start(name)
    return BUILD / f"lib{name}.so" if job is None else _finish(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib


def build_all() -> dict:
    """Build every kernel library, one nvcc per source all started together;
    returns {name: seconds until that library was ready}."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in EXTRA_FLAGS}
    times = {}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
        times[name] = time.perf_counter() - t0
    return times


@functools.lru_cache(maxsize=64)
def scratch_words(name: str, symbol: str, *shape: int) -> int:
    """Words of device scratch a launch of ``csrc/<name>.cu`` takes at
    ``shape``: its host-side layout function ``symbol`` (ints in, a long
    long out), asked once per shape."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(shape)
        fn.restype = ctypes.c_longlong
    return int(fn(*shape))


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
