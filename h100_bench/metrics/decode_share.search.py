"""``decode_share.search``: the share of the traced window, in %, spent in
``models/decode.py::decode_to_labeled`` (the decode and
its validity): the benchmark's host-clock span ``decode``
around each call, synchronised at the call's end."""

from h100_bench.metrics_common import span_share


def read(ctx):
    return span_share(ctx, "decode")
