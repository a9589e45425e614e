"""``decode_idle.search``: the share of the traced window, in %, in which the
device sat idle while the host was inside the program's ``decode`` span
(``models/decode.py::decode_to_labeled``) or a span inside it (the slot
loop's ``decode.model`` and ``decode.draw``, ``decode.unwrap``)."""

from h100_bench.metrics_program import idle_share, under


def read(ctx):
    return idle_share(ctx, under("decode"))
