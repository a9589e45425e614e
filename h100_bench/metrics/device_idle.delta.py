"""``device_idle.delta``: the share of the traced window in which no operation ran on
the device, in %, while the delta climbs ran (``metrics_common.idle_share``)."""

from h100_bench.metrics_common import idle_share as read  # noqa: F401
