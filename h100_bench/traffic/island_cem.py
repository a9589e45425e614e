"""Latent search: ``search/islands.py::island_cem_search`` as the runner's
search stage calls it, on a 64-dimension PCA subspace of encoded corpus
latents with the best-scoring corpus graphs as island seeds.

A unit is one call of ``iters`` iterations of ``islands x population``
decodes, then the exploit re-decodes, from the unit's own seed; its work is
the call's ``num_evals`` (candidates decoded, relabelled and scored).

Checked against the reference: a sample of rows of every decode call in the
window (the decode's every type and edge decision, remade from the
reference's logits with the uniforms the call drew), their relabelling and
validity, their scores, and each call's best against its float64 re-score.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import common, harness, inputs
from h100_bench.reference import bic as ref_bic
from h100_bench.reference import decode as ref_decode
from h100_bench.reference import pace as ref_pace


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int, device):
        from dags_vae_search_tpu_torch.scoring.bic import BicScorer, relabel_to_columns
        from dags_vae_search_tpu_torch.search import latent

        self.cfg, self.params, self.seed, self.device = cfg, params, seed, device
        self.counts: dict = {}
        s = cfg["search"]
        self.codes, self.cards = common.make_data(cfg, seed)
        self.scorer = BicScorer(common.dataset(self.codes, self.cards),
                                max_parents=cfg["max_parents"], device=device)
        self.weights = common.make_weights(cfg, seed, device)
        self.model = common.program_model(cfg, self.weights, device)

        # the runner's seeding: corpus latents, their PCA subspace, and the
        # best-scoring corpus graphs as the islands' first means
        labels, adj = inputs.corpus(inputs.rng_for(seed, "corpus"), cfg["num_vertices"],
                                    cfg["seed_corpus_graphs"], cfg["corpus"]["density_limit"],
                                    cfg["max_parents"])
        lab_t = torch.as_tensor(labels, device=device)
        adj_t = torch.as_tensor(adj, device=device)
        mus = latent.encode_mu(self.model, lab_t, adj_t).cpu().numpy()
        cols = relabel_to_columns(lab_t, adj_t)
        seed_scores = np.concatenate([self.scorer.score(cols[i:i + 256]).cpu().numpy()
                                      for i in range(0, len(cols), 256)])
        elite = np.argsort(-seed_scores)[: s["islands"]]
        k_sub = int(min(s["island_subspace"], mus.shape[1], len(mus) - 1))
        center = mus.mean(axis=0)
        _, _, vt = np.linalg.svd(mus - center, full_matrices=False)
        basis = vt[:k_sub]
        coords = (mus - center) @ basis.T
        sigma = coords.std(axis=0) + 1e-6
        self.space = dict(basis=basis, center=center, init_sigma=sigma, sigma_floor=sigma * 0.05,
                          init_means=coords[elite])
        self.calls: list = []
        self.results: list = []
        self.check_rng = inputs.rng_for(seed, "check")
        self._search(torch_seed_of(seed, -1), iters=1)  # warm: every shape of a call

    def _search(self, unit_seed: int, iters: int):
        from dags_vae_search_tpu_torch.search import islands

        s = self.cfg["search"]
        return islands.island_cem_search(
            self.model, self.scorer, seed=unit_seed, num_islands=s["islands"],
            population=s["island_population"], iters=iters, elite_frac=s["elite_frac"],
            smoothing=s["smoothing"], migrate_every=s["migrate_every"],
            temperature_range=tuple(s["temperature_range"]), exploit_repeats=s["exploit_repeats"],
            device=self.device, **self.space)

    def unit(self, k: int) -> float:
        with _capturing(self):
            res = self._search(torch_seed_of(self.seed, k), self.cfg["search"]["island_iters"])
        self.results.append((res.best_score, res.best_labels, res.best_adj))
        self.counts["candidates"] = self.counts.get("candidates", 0) + res.num_evals
        return float(res.num_evals)

    def instrument(self, spans, kernels) -> list:
        from dags_vae_search_tpu_torch.search import latent

        return [(latent, "decode_to_labeled", lambda fn: spans.wrap("decode", fn))]

    def release(self) -> None:
        del self.model, self.scorer
        self.model = self.scorer = None

    def control(self) -> dict:
        """The reference in the program's place at the control's precision:
        TF32 products for the decode's decisions, bfloat16 for the scores."""
        return {"control": self.check("tf32")}

    def check(self, prec: str) -> list:
        """The program's numbers against the reference; with ``prec``
        'tf32', the control's: the decode's decisions made by TF32 logits,
        the scores by bfloat16 arithmetic."""
        ref_pace.exact_matmul()
        m = common.model_settings(self.cfg)
        data = common.reference_data(self.cfg, self.codes, self.cards, self.device)
        decode_gap = ref_decode.decode_gap(self.weights, m, self.calls,
                                           None if prec == "fp32" else prec)
        # relabelling, validity and scores of the sampled rows, and each
        # call's best
        served, graphs = [], []
        for call in self.calls:
            for lab, adj, score in zip(call["out_labels"].cpu().numpy(),
                                       call["out_adj"].cpu().numpy(),
                                       call["scores"].cpu().numpy()):
                served.append(score)
                graphs.append(ref_bic.relabel(lab, adj))
        for best, lab, adj in self.results:
            served.append(best)
            graphs.append(ref_bic.relabel(lab, adj))
        valid = np.array([g is not None for g in graphs])
        cols = np.stack([g for g in graphs if g is not None]) if valid.any() else None

        def scores(dtype):
            out = np.full(len(graphs), -np.inf)
            if cols is not None:
                out[valid] = ref_bic.structure_scores(data, cols, dtype)
            return out

        want = scores(torch.float64)
        got = np.asarray(served, np.float64) if prec == "fp32" else scores(torch.bfloat16)
        both = np.isfinite(got) & np.isfinite(want)
        mismatch = int((np.isfinite(got) != np.isfinite(want)).sum())
        rel = np.abs(got[both] - want[both]) / np.abs(want[both])
        return [
            {"name": "decode_gap", "value": decode_gap},
            {"name": "score_rel_err", "value": float(rel.max()) if rel.size else 0.0},
            {"name": "score_feasibility_mismatches", "value": float(mismatch)},
        ]


def torch_seed_of(seed: int, k: int) -> int:
    return common.torch_seed(seed, f"unit{k}")


def _capturing(t: Traffic):
    """Patches that record, for every decode call of a unit, the
    generator's state at the call and a seed-drawn sample of its rows: the
    latents, the wrapped sequences the decode emitted, the unwrapped graphs
    and their scores."""
    from dags_vae_search_tpu_torch.models import decode as decode_mod
    from dags_vae_search_tpu_torch.search import islands

    emitted = {}

    def keep_emitted(sample_decode):
        def wrapped(*args, **kwargs):
            out = sample_decode(*args, **kwargs)
            emitted["labels"], emitted["adj"] = out[0], out[1]
            return out

        return wrapped

    def keep_call(decode_and_score):
        def wrapped(model, scorer, z, generator=None, temperature=1.0):
            state = generator.get_state()
            scores, labels, adj = decode_and_score(model, scorer, z, generator,
                                                   temperature=temperature)
            rows = torch.as_tensor(common.pick_rows(t.check_rng, z.shape[0],
                                                    t.params["check_rows_per_call"]),
                                   device=z.device)
            t.calls.append({
                "state": state, "batch": z.shape[0], "rows": rows,
                "temperature": temperature, "max_in_degree": scorer.max_parents,
                "z": z.index_select(0, rows), "labels": emitted["labels"].index_select(0, rows),
                "adj": emitted["adj"].index_select(0, rows),
                "out_labels": labels.index_select(0, rows), "out_adj": adj.index_select(0, rows),
                "scores": scores.index_select(0, rows),
            })
            return scores, labels, adj

        return wrapped

    return harness.patched([(decode_mod, "sample_decode", keep_emitted),
                            (islands, "decode_and_score", keep_call)])
