"""Operations and bytes of the particle filter's two kernel calls, from
the cell's shapes alone: n particles, a predict call's K parameter rows
and its ``nticks`` real ticks. Bytes count each input the math needs read
once and each output written once (float32 bank rows, the per-tick
parameter rows and seeds, int32 counts, one moment partial of eight sums
per 1024 particles and tick); float operations count the formulas; integer
operations count the counter-based generator (``csrc/pf_rng.cuh``), whose
shifts, xors and adds take the integer ALU, a pipe of its own.

- ``predict``: K5, ``nticks`` motion ticks of the (6, n) bank with the
  moment sums of each; a Box-Muller pair (two uniforms) per noise row pair
  that is on (x/y, yaw).
- ``gather``: K7 with the jitter: the ancestor expansion of the int32
  counts, the bank's gather, the x/y/yaw jitter (two pairs, four
  uniforms) and the post-resample moment sums.
"""

from navbench.roofline import peaks

# The integer ALU of one H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz
# boost (NVIDIA H100 Tensor Core GPU Architecture whitepaper); the
# generator's multiplies issue on the FMA pipe and count as float work
INT_ALU_OPS_PER_S = 16.7e12
UNIFORM_ALU_OPS = 15    # 7 shifts, 7 xors and the key's add of one 24-bit uniform
UNIFORM_IMADS = 4       # its four 32-bit multiplies (two per mix32)
TICK_FLOPS = 50         # one particle's predict tick: Box-Muller, motion, moment sums
JITTER_FLOPS = 40       # one particle's jitter and moment sums
F32, I32 = 4, 4
N_SUMS, SUM_GROUP = 8, 1024


def bound_s(n_bytes: float, flops: float, alu_ops: float) -> float:
    """The least time: bytes over bandwidth, float work (each IMAD two
    float slots of the FMA pipe) over the float32 rate, or integer ALU
    operations over the ALU's rate, whichever is largest."""
    return max(peaks.bound_s(n_bytes, flops), alu_ops / INT_ALU_OPS_PER_S)


def _partials(n: int) -> int:
    return (n + SUM_GROUP - 1) // SUM_GROUP


def predict(n: int, K: int, nticks: int, nxy: bool = False, nyaw: bool = True) -> tuple:
    """(bytes, float operations, ALU operations) of one K5 call."""
    uniforms = n * nticks * 2 * (int(nxy) + int(nyaw))
    n_bytes = 2 * 6 * n * F32 + K * (16 * F32 + I32) + K * N_SUMS * _partials(n) * F32
    flops = n * nticks * TICK_FLOPS + 2 * UNIFORM_IMADS * uniforms
    return n_bytes, flops, UNIFORM_ALU_OPS * uniforms


def gather(n: int) -> tuple:
    """(bytes, float operations, ALU operations) of one K7 call with the
    jitter."""
    uniforms = 4 * n
    n_bytes = n * I32 + 2 * 6 * n * F32 + 3 * F32 + N_SUMS * _partials(n) * F32
    flops = n * JITTER_FLOPS + 2 * UNIFORM_IMADS * uniforms
    return n_bytes, flops, UNIFORM_ALU_OPS * uniforms
