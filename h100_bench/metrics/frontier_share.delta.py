"""``frontier_share.delta``: the share of the traced window, in %, that the host
spent in the self time of the delta climb's ``delta.frontier`` spans
(``search/delta_hillclimb.py``)."""

from h100_bench.metrics_program import self_share


def read(ctx):
    return self_share(ctx, {"delta.frontier"})
