"""``score_share.climb``: the share of the traced window, in %, spent in
``scoring/bic.py::BicScorer.score``: the benchmark's host-clock span ``score``
around each call, synchronised at the call's end."""

from h100_bench.metrics_common import span_share


def read(ctx):
    return span_share(ctx, "score")
