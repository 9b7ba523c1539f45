"""The yardstick of the kernel rooflines: the H100's published peaks and
the operations and bytes of the packed blend forward (B4) and backward
(B5), counted from a launch's pack shape and the slots its tiles marched.

Peaks: NVIDIA's H100 SXM data sheet at the 700 W power limit, HBM3 at
3.35 TB/s and FP32 outside the tensor cores at 67 TFLOP/s. The least time
of a launch is the larger of its bytes over the memory rate and its
operations over the FP32 rate.

Operations per (tile-slot, pixel) marched (the kernels' float32
expression): forward 16 for the weight, 1 for the gate, 8 for the four
colour and depth multiply-adds, 2 for the transmittance; the backward adds
30 for dL/dalpha, 4 for the gates, 25 for the ten field gradients and 10
for their reductions. Bytes: each marched slot's 10 fields read once, the
chunk and tile maps read once, the outputs written once (forward: colour,
depth, transmittance, march lengths and the per-slot counts; backward:
the forward's outputs and the incoming gradients read, the per-slot field
gradients written)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KC = 32  # slots per chunk
NF = 10  # fields per slot
P = 256  # pixels per tile
OPS_FWD = 16 + 1 + 8 + 2
OPS_BWD = OPS_FWD + 30 + 4 + 25 + 10


def least_seconds(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def packed_work(kind: str, NB: int, G: int, TG: int, marched: int) -> tuple[float, float]:
    """(bytes, operations) of one packed blend launch of (NB, G) chunks and
    groups of TG tiles whose tiles marched `marched` tile-slots in all."""
    out_bytes = ((G + 1) * 4 * TG * P + (G + 1) * TG * P + (G + 1) * TG) * 4
    idx_bytes = (NB + NB * TG + 1) * 4
    nt_bytes = NB * KC * TG * 4
    slot_bytes = marched * NF * 4
    if kind == "fwd":
        return slot_bytes + idx_bytes + out_bytes + nt_bytes, marched * P * OPS_FWD
    if kind == "bwd":
        return slot_bytes + idx_bytes + 2 * out_bytes + nt_bytes * NF, marched * P * OPS_BWD
    raise ValueError(kind)


def roofline_pct(record: dict, kind: str, kernel: str):
    """Share (%) of the least time of the float32 `kind` launches logged in
    the traced window over the device time of the kernels named `kernel`
    there; None where there is neither."""
    tr = record.get("trace")
    if not tr:
        return None
    lo, hi = tr["t_start"], tr["t_stop"]
    least = sum(least_seconds(*packed_work(kind, L["NB"], L["G"], L["TG"], L["marched"]))
                for L in record["launches"] if L["kind"] == kind and not L["bf16"])
    busy = sum(min(e, hi) - max(s, lo) for n, s, e in tr["events"]
               if kernel in n and s < hi and e > lo)
    if least <= 0.0 or busy <= 0.0:
        return None
    return 100.0 * least / busy
