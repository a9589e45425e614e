"""``decode_model_share.search``: the stream time of the decoder's transformer
step, in % of the traced window: the time between the CUDA events that the
program's ``decode.model`` spans record on the stream around
``model.decode_step_cached`` (the slot's new position over the call's
key/value cache) in each slot of ``models/decode.py::decode_to_labeled``,
summed over the window.  It counts the step's idle stretches too (the stream
waiting for the host's next launch inside the step), so it can read above the
window's busy share; the device's busy time within the step needs each
operation's launching span, which the profiler's events do not carry as the
harness reads them."""

from h100_bench.metrics_program import device_share


def read(ctx):
    return device_share(ctx, "decode.model")
