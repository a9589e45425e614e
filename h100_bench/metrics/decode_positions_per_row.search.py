"""``decode_positions_per_row.search``: decoder positions computed per decoded
row: the program's counters ``decode.positions`` over ``decode.rows``
(``models/decode.py``).  A decoder that keeps each built position's keys and
values runs every position once, N - 1 a row (39 at alarm); one that
recomputes every position at every slot runs (N - 2) x N."""

from h100_bench.metrics_program import count


def read(ctx):
    positions, rows = count(ctx, "decode.positions"), count(ctx, "decode.rows")
    if positions is None or not rows:
        return None
    return positions / rows
