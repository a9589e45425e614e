"""``score_kernel_roofline``: the wide score kernel's share of its roofline,
in % (``ops/bic_kernel.py::node_scores_fused_wide`` ->
``csrc/contingency_counts.cu``): the summed bound of its launches' inputs
(``peaks.score_bound``) over its summed device time in the traced window,
its finishing kernel's included.  Nothing to read where the window made no
such launch."""

from h100_bench import peaks
from h100_bench.metrics_common import roofline


def read(ctx):
    return roofline(ctx, "score_wide",
                    {"main": ("node_scores_wide_kernel", "node_scores_finish_kernel")},
                    lambda r: peaks.score_bound(r["rows"], r["n"], r["unique"], r["code_bytes"],
                                                r["filled"]))
