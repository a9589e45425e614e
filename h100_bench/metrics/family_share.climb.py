"""``family_share.climb``: the share of the traced window, in %, spent in
``scoring/family_batch.py::FamilyBatchScorer.score_chunked``
(host work included): the benchmark's host-clock span ``family``
around each call, synchronised at the call's end."""

from h100_bench.metrics_common import span_share


def read(ctx):
    return span_share(ctx, "family")
