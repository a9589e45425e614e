"""``climb_mfu``: the dense structure climbs' share of the card's INT32
peak, in %: a lower bound of the counting the accepted moves need, over the traced
window, over 132 x 64 lanes at 1.98 GHz.

After a move a climber must at least re-rank the n - 1 parent-set variants
of one changed child over the U unique data rows, at d + 2 integer
operations a row (d parents' multiply-adds, the child and the bin), d the
mean in-degree of the climbs' final DAGs: moves x (n - 1) x U x (d + 2).
Counted from the moves, not from the rows the program scored.
"""

import numpy as np

from h100_bench import peaks


def climb_ops(moves: int, n: int, unique: int, mean_in_degree: float) -> float:
    return float(moves) * (n - 1) * unique * (mean_in_degree + 2.0)


def read(ctx):
    moves, dags = ctx.counts.get("moves"), ctx.counts.get("final_dags")
    if not moves or not dags or ctx.window_s <= 0:
        return None
    n = ctx.config["num_vertices"]
    d = float(np.mean([(np.asarray(a) > 0).sum() / n for a in dags]))
    ops = climb_ops(moves, n, ctx.counts["unique_rows"], d)
    return 100.0 * ops / ctx.window_s / peaks.INT32_PER_S
