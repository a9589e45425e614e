"""``families_per_move.delta``: families the delta climbs sent to scoring per
move they accepted: the program's counters ``delta.families`` over
``delta.moves`` (``search/delta_hillclimb.py``)."""

from h100_bench.metrics_program import count


def read(ctx):
    families, moves = count(ctx, "delta.families"), count(ctx, "delta.moves")
    if families is None or not moves:
        return None
    return families / moves
