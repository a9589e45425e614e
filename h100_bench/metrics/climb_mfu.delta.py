"""``climb_mfu.delta``: the delta climbs' share of the card's INT32 peak, in
%, counted as ``climb_mfu`` counts the dense climbs' (a lower bound of the
counting the accepted moves need)."""

from h100_bench import harness

_dense = harness.load_module(harness.HERE / "metrics" / "climb_mfu.py")


def read(ctx):
    return _dense.read(ctx)
