"""Aggregate the port's stage reports into RESULTS_torch.md.

Counterpart of ``dags_vae_search_tpu/experiments/results.py``: the same
table and lines from the same report dicts; the header names the devices
the reports were measured on (each report's ``"device"``), and the page is
written to ``RESULTS_torch.md`` by default, never to the JAX package's
``RESULTS.md``.
"""

from __future__ import annotations

import glob
import json
import os
import sys


def collect(runs_dir: str) -> dict:
    """Merge stage reports from the runs dir AND its ``reports_torch/``
    mirror (the runner writes both — runner.py ``report``); the mirror
    survives a wipe of the runs dir.  When both hold a report for the same
    (experiment, stage), the newer ``time`` stamp wins."""
    mirror = os.path.join(os.path.dirname(os.path.abspath(runs_dir)), "reports_torch")
    out: dict = {}
    stamps: dict = {}
    for root in (mirror, runs_dir):
        for path in sorted(glob.glob(os.path.join(root, "*", "report_*.json"))):
            experiment = os.path.basename(os.path.dirname(path))
            stage = os.path.basename(path)[len("report_") : -len(".json")]
            try:
                with open(path) as fh:
                    payload = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            stamp = payload.get("time", 0.0)
            key = (experiment, stage)
            if key in stamps and stamps[key] > stamp:
                continue
            stamps[key] = stamp
            out.setdefault(experiment, {})[stage] = payload
    return out


def fmt(x, nd=3):
    if x is None:
        return "—"
    if isinstance(x, float):
        return f"{x:,.{nd}f}"
    return str(x)


def _gap_pct(search: dict):
    """Hill-climb gap to the simulated ground-truth structure's BIC,
    computed from the report (not hardcoded): (gt - hc) / |gt|.  Negative
    means the climber BEAT the data-generating structure."""
    gt = search.get("ground_truth_bic")
    hc = (search.get("hill_climb") or {}).get("best_bic")
    if not isinstance(gt, (int, float)) or not isinstance(hc, (int, float)):
        return None
    if gt != gt or hc != hc or gt == 0:
        return None
    return (gt - hc) / abs(gt)


def devices(reports: dict) -> list:
    """The devices the reports name, sorted."""
    return sorted({
        payload["device"]
        for stages in reports.values()
        for payload in stages.values()
        if isinstance(payload, dict) and isinstance(payload.get("device"), str)
    })


def render(reports: dict) -> str:
    # <exp>@<variant> runs are sweep probes — rendered in their own section
    # so the main table stays one row per canonical experiment.
    measured_on = "; ".join(devices(reports)) or "device not recorded"
    variants = {k: v for k, v in reports.items() if "@" in k}
    reports = {k: v for k, v in reports.items() if "@" not in k}
    lines = [
        f"# RESULTS — measured pipeline numbers ({measured_on})",
        "",
        "Generated by `python -m dags_vae_search_tpu_torch.experiments.results`.",
        "Reference baselines: BASELINE.md (recon best 0.935 asia@100ep;",
        "GP deployed MAPE 0.052; BIC scoring ~1 graph/subprocess).",
        "",
        "| experiment | train graphs/s | final loss/graph | valid | structure acc | acc (mode) | perfect acc | GP MAPE | exact optimum BIC | hill-climb BIC | best latent BIC |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, stages in sorted(reports.items()):
        train = stages.get("train", {})
        final = train.get("final") or {}
        eva = stages.get("eval", {})
        gp = stages.get("gp", {})
        search = stages.get("search", {})
        hc = search.get("hill_climb") or {}
        opt = search.get("exact_optimum") or {}
        # Best latent-driven result: raw island CEM, its hill-climb-polished
        # hybrid, anchor refinement, or GP ascent (exact rescoring preferred).
        latent_vals = []
        for key in (
            "island_cem",
            "island_cem_polished",
            "latent_refined",
            "gp_ascent",
            "bo",
        ):
            entry = search.get(key)
            if isinstance(entry, dict):
                v = entry.get("best_bic_exact", entry.get("best_bic"))
                if isinstance(v, (int, float)) and v == v and v != float("-inf"):
                    latent_vals.append(v)
        cem_val = max(latent_vals) if latent_vals else None
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} | {} | {} | {} | {} |".format(
                name,
                fmt(final.get("graphs_per_second"), 0),
                fmt(final.get("loss_per_graph"), 5),
                fmt(eva.get("valid_ratio")),
                fmt(eva.get("structure_accuracy")),
                fmt(eva.get("structure_accuracy_mode")),
                fmt(eva.get("perfect_accuracy")),
                fmt(gp.get("mape"), 4),
                fmt(opt.get("best_bic"), 2),
                fmt(hc.get("best_bic"), 2),
                fmt(cem_val, 2),
            )
        )
    lines.append("")
    for name, stages in sorted(reports.items()):
        rt = stages.get("roundtrip")
        if rt:
            lines.append(
                f"- **{name} roundtrip** (experiment-00 parity): true BIC "
                f"{fmt(rt.get('true_bic'), 2)}, GP predicted "
                f"{fmt(rt.get('gp_predicted_bic'), 2)} (rel err "
                f"{fmt(rt.get('relative_error'), 4)}), decode equal: "
                f"{rt.get('decode_equal')}"
            )
        search = stages.get("search", {})
        if "ground_truth_bic" in search:
            lines.append(
                f"- **{name}** simulated ground-truth structure BIC: "
                f"{fmt(search['ground_truth_bic'], 2)}"
            )
    lines.append("")
    if variants:
        lines += [
            "## Recipe sweeps (variant probes)",
            "",
            "| variant | epochs | final loss/graph | kld/graph | graphs/s | structure acc |",
            "|---|---|---|---|---|---|",
        ]
        for name, stages in sorted(variants.items()):
            train = stages.get("train", {})
            final = train.get("final") or {}
            eva = stages.get("eval", {})
            lines.append(
                "| {} | {} | {} | {} | {} | {} |".format(
                    name,
                    fmt(train.get("epochs")),
                    fmt(final.get("loss_per_graph"), 3),
                    fmt(final.get("kld_per_graph"), 2),
                    fmt(final.get("graphs_per_second"), 0),
                    fmt(eva.get("structure_accuracy")),
                )
            )
        lines.append("")
    lines += [
        "## Per-experiment search detail",
        "",
    ]
    for name, stages in sorted(reports.items()):
        search = stages.get("search", {})
        if not search:
            continue
        parts = []
        for key in (
            "exact_optimum",
            "hill_climb",
            "island_cem",
            "island_cem_polished",
            "latent_refined",
            "gp_ascent",
            "bo",
        ):
            entry = search.get(key)
            if isinstance(entry, dict):
                value = entry.get("best_bic_exact", entry.get("best_bic"))
                detail = f"{key} {fmt(value, 2)} ({fmt(entry.get('evals', entry.get('families')), 0)} evals, {fmt(entry.get('seconds'), 1)}s"
                if entry.get("converged") is True:
                    detail += ", converged"
                elif entry.get("converged") is False:
                    detail += ", budget-limited"
                rate = entry.get("evals_per_sec")
                if isinstance(rate, (int, float)) and rate > 0:
                    detail += f", {rate:,.0f} evals/s"
                prof = entry.get("profile")
                if isinstance(prof, dict) and prof:
                    detail += "; profile " + " ".join(
                        f"{k.removesuffix('_s')}={v:.0f}s"
                        for k, v in prof.items()
                    )
                parts.append(detail + ")")
        bc = search.get("budget_comparison")
        if isinstance(bc, dict):
            seg = ", ".join(
                f"{k} {fmt(v.get('best_bic_exact'), 2)} ({fmt(v.get('seconds'), 1)}s)"
                for k, v in bc.items()
                if isinstance(v, dict)
            )
            parts.append(
                f"fixed-budget @{bc.get('budget_evals')} evals: {seg} -> "
                f"winner {bc.get('winner')}"
            )
        gap = _gap_pct(search)
        if gap is not None:
            parts.append(f"hill-climb gap to ground truth {gap:+.2%}")
        if parts:
            lines.append(f"- **{name}**: " + "; ".join(parts))
    lines += ["", "## Key takeaways vs the reference", ""]
    lines += _takeaways(reports)
    lines.append("")
    return "\n".join(lines)


#: Reference reconstruction anchors (code-comment traces in the reference:
#: asia 0.935 at ``experiments/01_bn_asia/main.py:560``; synthetic_12
#: 0.364-0.389 at ``experiments/03_synthetic_12/main.py:236-239``; GP
#: deployed MAPE 0.052 at ``experiments/01_bn_asia/main.py:566-568``).
REFERENCE_ANCHORS = {
    "recon": {"asia": 0.935, "synthetic_12": 0.389},
    "gp_mape": {"asia": 0.052},
}


def _takeaways(reports: dict) -> list:
    """Every takeaway line is COMPUTED from the collected reports (plus
    labeled reference-anchor constants) — a claim with no live report behind
    it simply does not render."""
    out = []
    for name, ref in REFERENCE_ANCHORS["recon"].items():
        eva = (reports.get(name) or {}).get("eval") or {}
        acc = eva.get("structure_accuracy")
        if isinstance(acc, (int, float)):
            out.append(
                f"- {name} reconstruction: structure {acc:.3f} / perfect "
                f"{eva.get('perfect_accuracy', float('nan')):.3f} "
                f"(reference best: {ref})."
            )
    mapes = [
        (name, stages["gp"]["mape"])
        for name, stages in sorted(reports.items())
        if isinstance((stages.get("gp") or {}).get("mape"), (int, float))
    ]
    if mapes:
        ref_note = "".join(
            f" (reference deployed: {REFERENCE_ANCHORS['gp_mape'][n]})"
            for n, _ in mapes
            if n in REFERENCE_ANCHORS["gp_mape"]
        )
        out.append(
            "- GP surrogate MAPE: "
            + ", ".join(f"{n} {m:.3f}" for n, m in mapes)
            + ref_note
            + "."
        )
    matched, beat_gt = [], []
    for name, stages in sorted(reports.items()):
        search = stages.get("search") or {}
        opt = (search.get("exact_optimum") or {}).get("best_bic")
        bests = []
        for key in (
            "hill_climb",
            "island_cem",
            "island_cem_polished",
            "latent_refined",
            "gp_ascent",
            "bo",
        ):
            entry = search.get(key)
            if isinstance(entry, dict):
                v = entry.get("best_bic_exact", entry.get("best_bic"))
                if isinstance(v, (int, float)) and v == v:
                    bests.append(v)
        if (
            isinstance(opt, (int, float))
            and bests
            and max(bests) >= opt - 1e-2
        ):
            matched.append(name)
        gap = _gap_pct(search)
        if gap is not None and gap < 0:
            beat_gt.append(name)
    if matched:
        out.append(
            "- Search (absent in the reference): a non-exact strategy "
            "matches the certified DP optimum on "
            + ", ".join(matched)
            + "."
        )
    if beat_gt:
        out.append(
            "- Hill climbing beats the data-generating structure's BIC on "
            + ", ".join(beat_gt)
            + "."
        )
    rates = [
        (name, stages["search"]["hill_climb"]["evals_per_sec"])
        for name, stages in sorted(reports.items())
        if isinstance(
            (stages.get("search", {}).get("hill_climb") or {}).get(
                "evals_per_sec"
            ),
            (int, float),
        )
    ]
    if rates:
        top = max(rates, key=lambda kv: kv[1])
        out.append(
            f"- Peak measured structure-search rate: {top[1]:,.0f} BIC "
            f"move-evals/s ({top[0]}); the reference scores ~10/s through "
            "its per-graph R subprocess."
        )
    bo_wins = [
        name
        for name, stages in sorted(reports.items())
        if (
            (stages.get("search", {}).get("budget_comparison") or {}).get(
                "winner"
            )
            == "bo"
        )
    ]
    if bo_wins:
        out.append(
            "- Closed-loop BO wins the fixed-real-eval-budget comparison "
            "(vs gp_ascent and cold island CEM, identical seeds) on "
            + ", ".join(bo_wins)
            + "."
        )
    scale_parts = []
    for name in ("andes", "link"):
        gap = _gap_pct((reports.get(name) or {}).get("search", {}))
        if gap is None:
            continue
        hc = reports[name]["search"].get("hill_climb") or {}
        status = (
            "converged local optimum"
            if hc.get("converged")
            else "anytime budget"
        )
        scale_parts.append(f"{name} {gap:+.2%} vs ground truth ({status})")
    if scale_parts:
        lines_note = (
            "- Large-n (bit-packed corpora, blocked closures) family-delta "
            "hill-climb: " + "; ".join(scale_parts) + "."
        )
        out.append(lines_note)
    if not out:
        out.append("- (no live reports collected — run the pipeline first)")
    return out


def main(argv=None):
    """``[runs_dir [out_path]]``: render the reports of ``runs_dir``
    (default ``runs``) into ``out_path`` (default ``RESULTS_torch.md``)."""
    argv = argv if argv is not None else sys.argv[1:]
    runs_dir = argv[0] if argv else "runs"
    out_path = argv[1] if len(argv) > 1 else "RESULTS_torch.md"
    if os.path.basename(out_path) == "RESULTS.md":
        raise ValueError("RESULTS.md holds the JAX package's results; write the port's elsewhere")
    text = render(collect(runs_dir))
    with open(out_path, "w") as fh:
        fh.write(text)
    print(text)


if __name__ == "__main__":
    main()
