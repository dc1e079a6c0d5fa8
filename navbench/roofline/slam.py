"""Operations and bytes of the SLAM fleet tick's kernel layers, from the
cell's shapes alone: B missions, L landmark slots, M detections per tick,
D = 6 + 3L, dim = 3 (MBES). Bytes count each input the math needs read
once and each output written once (float32, int32 and one-byte flags),
whatever layout an implementation passes; float operations count the
formulas, the assignment's data-dependent steps left out. Both are per
call, one call per tick, with the motion predict carried into the call.

- ``da``: the data-association stage (the port's K1): per slot the point
  model and its Jacobian, S = H Σ9 Hᵀ + Q and its inverse, the gated
  costs of every detection; per detection the back-projected candidate's
  own; the predict applied to the pose block it reads. Reads the pose,
  the slots' positions and flags, Σ's six pose rows, each slot's 3×3 block
  (six unique entries), the detections, the predict's A and R; writes per
  detection H, S⁻¹H, ν, the candidate, the slot and its two flags.
- ``update``: the sequential update of the M detections in factor form
  (the port's K2 phase 1 + K12): reads Σ, μ, the DA stage's outputs, the
  slots' blocks and the predict's A and R; writes Σ, μ and the blocks.
"""

F32, I32, FLAG = 4, 4, 1


def da(B: int, L: int, M: int, dim: int = 3) -> tuple:
    """(bytes, float operations) of one DA call."""
    D = 6 + 3 * L
    reads = (B * (6 * F32 + I32 + L * FLAG + 3 * L * F32 + 6 * D * F32 + 6 * L * F32
                  + M * 3 * F32 + M * FLAG + 72 * F32) + 9 * F32)
    writes = B * M * (2 * dim * 9 * F32 + dim * F32 + 3 * F32 + I32 + 2 * FLAG)
    inn = 2 * dim * 81 + 2 * dim * dim * 9 + 30
    model = 72 + (60 if dim == 2 else 0)
    per_slot = model + inn + M * (2 * dim * dim + 2 * dim) + 216
    per_cand = 18 + model + inn
    flops = B * (L * per_slot + M * per_cand + M * dim * 9 * dim * 2 + 864)
    return reads + writes, flops


def update(B: int, L: int, M: int, dim: int = 3) -> tuple:
    """(bytes, float operations) of one update call."""
    D = 6 + 3 * L
    K = M * dim
    reads = B * (D * D * F32 + D * F32 + M * (2 * dim * 9 + dim + 3) * F32
                 + M * (I32 + 2 * FLAG) + 6 * L * F32 + 72 * F32) + 3 * F32
    writes = B * (D * D * F32 + D * F32 + 6 * L * F32)
    upd = D * (9 * dim * M * (M - 1) + 36 * dim * M)
    flops = B * (upd + 2 * K * D * D + 2 * K * D + 72 * D)
    return reads + writes, flops
