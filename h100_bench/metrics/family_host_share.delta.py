"""``family_host_share.delta``: the share of the traced window, in %, that the
host spent in the family scorer's own work (``scoring/family_batch.py``): the
self time of its ``family.upload``, ``family.launch`` and ``family.reduce``
spans; the wait for the scores in ``family.read`` is left out."""

from h100_bench.metrics_program import self_share


def read(ctx):
    return self_share(ctx, {"family.upload", "family.launch", "family.reduce"})
