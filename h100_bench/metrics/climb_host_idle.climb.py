"""``climb_host_idle.climb``: the share of the traced window, in %, in which the
device sat idle while the host was innermost in the dense climb's own spans
(``climb``, ``climb.candidates``, ``climb.feasible``, ``climb.read``,
``climb.restart`` of ``search/hillclimb.py``), not in the scorer's
``score``."""

from h100_bench.metrics_program import idle_share


def _climb(span, spans):
    return span["name"] == "climb" or span["name"].startswith("climb.")


def read(ctx):
    return idle_share(ctx, _climb)
