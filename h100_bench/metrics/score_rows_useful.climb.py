"""``score_rows_useful.climb``: the share of the rows the dense climb sent to
the scorer, in %, that were distinct feasible moves: the program's counters
``climb.moves_feasible`` (feasible moves among the rows a step had not
scored yet) over ``climb.rows_scored`` (``search/hillclimb.py::hill_climb``)."""

from h100_bench.metrics_program import count


def read(ctx):
    useful, rows = count(ctx, "climb.moves_feasible"), count(ctx, "climb.rows_scored")
    if useful is None or not rows:
        return None
    return 100.0 * useful / rows
