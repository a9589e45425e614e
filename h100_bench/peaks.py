"""The yardstick's constants: the published peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet, dense rates, at its 700 W limit), never read from the
card, and the roofline bounds of the contingency kernels.  Device time
comes from the profiler's raw events (``harness.read_trace``).

The integer peak is 132 SMs x 64 INT32 lanes at the published 1.98 GHz
boost clock: a yardstick that does not move with the clock the card runs at.
"""

from __future__ import annotations

#: float32 operations a second outside the tensor cores
FP32_PER_S = 67e12
#: HBM3 bytes a second
BYTES_PER_S = 3.35e12
#: INT32 lanes of the card (132 SMs x 64)
INT32_LANES = 132 * 64
#: the published boost clock the integer peak is taken at
CLOCK_HZ = 1.98e9
#: INT32 operations a second
INT32_PER_S = INT32_LANES * CLOCK_HZ


def bound_of(nbytes: float, ops: float, flops: float = 0.0) -> dict:
    """The least time of work that moves ``nbytes`` and does ``ops`` INT32
    and ``flops`` float32 operations: the larger of the three times."""
    bytes_s = nbytes / BYTES_PER_S
    ops_s = max(ops / INT32_PER_S, flops / FP32_PER_S)
    return {"bytes": nbytes, "int_ops": ops, "float_ops": flops, "bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def score_bound(rows: int, n: int, unique: int, code_bytes: int, filled: int) -> dict:
    """The score entry's bound for ``rows`` (candidate, node) rows of ``n``
    nodes over ``unique`` unique data rows: strides, codes, weights, config
    sizes and cards read once, one float a row written; per row and unique
    row its filled parents' multiply-adds, the child and the bin (``filled``
    parent slots over all rows).  The reduction's float work per filled
    cell is below this integer work at any shape (a cell per row and unique
    row at most, 4 float operations at 4x the integer rate), so it is not
    counted."""
    nbytes = rows * n * 4 + code_bytes + unique * 4 + rows * 4 + n * 4 + rows * 4
    return bound_of(nbytes, unique * (filled + 2 * rows))


def family_bound(families: int, slots: int, n: int, unique: int, code_bytes: int, bins: int,
                 filled: int) -> dict:
    """The family entry's bound: the families (child and ``slots`` parent
    slots, int32), the cards, the codes and the weights read once,
    ``families x bins`` counts written; per family and unique row its filled
    slots' multiply-adds, the child and the bin."""
    nbytes = families * (slots + 1) * 4 + n * 4 + code_bytes + unique * 4 + families * bins * 4
    return bound_of(nbytes, unique * (filled + 2 * families))

