"""Structure search by delta hill climbing: ``search/delta_hillclimb.py::
delta_hill_climb`` under ``climb_with_restarts``, as the runner's search
stage runs it at n > 48 (cached family gains on the host, the changed
children's families re-scored through ``FamilyBatchScorer`` after each
accepted batch of moves).  No model runs.

A unit is one climb with its restarts, from a DAG drawn from the unit's
seed; its work is the edge changes the climbs accepted.

Checked against the reference: a seed-drawn sample of the families of the
scorer's calls (their scores and feasibility), and every climb finished in
the window as the dense climb's are.
"""

from __future__ import annotations

import numpy as np

from h100_bench.reference import bic as ref_bic
from h100_bench.traffic import _climbs


class Traffic(_climbs.ClimbTraffic):
    def make_climb(self):
        from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
        from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb

        s = self.cfg["search"]
        self.fam = FamilyBatchScorer(self.dataset, max_parents=self.cfg["max_parents"],
                                     q_cap=self.cfg["q_cap"], device=self.device)
        self.sampled_calls(self.fam, "score", lambda kids, parents, out: (kids, parents, out))
        n = self.cfg["num_vertices"]
        return lambda init: delta_hill_climb(self.fam, n, init_adj=init,
                                             max_iters=s["hill_climb_iters"],
                                             chunk=s["family_chunk"],
                                             accept_batch=s["hill_climb_accept_batch"])

    def reference_climb(self, data, dtype):
        from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb

        s, n = self.cfg["search"], self.cfg["num_vertices"]
        fam = ref_bic.FamilyScorer(data, dtype)
        return lambda init: delta_hill_climb(fam, n, init_adj=init,
                                             max_iters=s["hill_climb_iters"],
                                             chunk=s["family_chunk"],
                                             accept_batch=s["hill_climb_accept_batch"])

    def instrument(self, spans, kernels) -> list:
        from dags_vae_search_tpu_torch.ops import bic_kernel

        return [(self.fam, "score_chunked", lambda fn: spans.wrap("family", fn)),
                (bic_kernel, "_launch_family", _climbs.record(kernels, "family", _family_launch))]

    def release(self) -> None:
        self.fam = None

    def sample_check(self, data, dtype) -> tuple:
        """Served and reference scores of the sampled families."""
        if not self.samples:
            return np.zeros(0), np.zeros(0)
        kids = np.concatenate([k for k, _, _ in self.samples])
        parents = np.concatenate([p for _, p, _ in self.samples])
        served = np.concatenate([s for _, _, s in self.samples]).astype(np.float64)
        return served, ref_bic.family_scores(data, kids, parents, dtype)


def _family_launch(children, parents, codes_cm, cards, w, q_cap, r_max, cluster=None,
                   wide=False, **_) -> dict:
    """The family entry's launch sizes: its route, families, parent slots,
    nodes, unique rows, the codes' bytes, bins and the filled parent slots."""
    return {"route": "wide" if wide else "narrow",
            "families": parents.shape[0], "slots": parents.shape[1], "n": cards.shape[0],
            "unique": w.shape[0], "code_bytes": codes_cm.numel() * codes_cm.element_size(),
            "bins": q_cap * r_max, "filled": (parents >= 0).sum()}
