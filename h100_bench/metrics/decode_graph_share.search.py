"""``decode_graph_share.search``: the share, in %, of the rows the traced
window decoded that replayed CUDA graphs captured before their call: the
program's counters ``decode.graph_rows`` over ``decode.rows``
(``models/decode.py``).  A decode whose workspace was captured in an earlier
call (set-up's warm unit) replays one graph for the memory and two a slot in
place of the slot's eager launches; 100 means no capture and no eager slot
fell inside the window."""

from h100_bench.metrics_program import count


def read(ctx):
    graph_rows, rows = count(ctx, "decode.graph_rows"), count(ctx, "decode.rows")
    if graph_rows is None or not rows:
        return None
    return 100.0 * graph_rows / rows
