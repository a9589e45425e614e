"""``family_kernel_roofline``: the family entry's kernels' share of their
roofline, in % (``ops/bic_kernel.py::contingency_counts_family`` ->
``csrc/contingency_counts.cu``, whichever route its calls take: the narrow
cluster kernel, the wide kernel): the summed bound of the launches' inputs
(``peaks.family_bound``) over their summed device time in the traced
window.  Nothing to read where the window made no such launch."""

from h100_bench import peaks
from h100_bench.metrics_common import roofline


def read(ctx):
    routes = {"narrow": ("contingency_counts_family_cluster_kernel",),
              "wide": ("contingency_counts_rows_wide_kernel<(anonymous namespace)::FamilyRows",)}
    present = {r["route"] for r in ctx.kernels.get("family", [])}
    return roofline(ctx, "family", {k: v for k, v in routes.items() if k in present},
                    lambda r: peaks.family_bound(r["families"], r["slots"], r["n"], r["unique"],
                                                 r["code_bytes"], r["bins"], r["filled"]))
