"""Structure search by dense hill climbing: ``search/hillclimb.py::hill_climb``
under ``climb_with_restarts``, as the runner's search stage runs it at
n <= 48 (every single-edge move scored as a whole candidate through
``BicScorer.score``, in chunks).  No model runs.

A unit is one climb with its restarts, from a DAG drawn from the unit's
seed; its work is the edge changes the climbs accepted.

Checked against the reference: a seed-drawn sample of the candidates of
the scorer's calls (their scores and feasibility), and every climb finished
in the window: its score against its float64 re-score, acyclicity, the
in-degree cap, and the largest gain of a single move left where it claims a
local optimum.
"""

from __future__ import annotations

import numpy as np

from h100_bench.reference import bic as ref_bic
from h100_bench.traffic import _climbs


class Traffic(_climbs.ClimbTraffic):
    def make_climb(self):
        from dags_vae_search_tpu_torch.scoring.bic import BicScorer
        from dags_vae_search_tpu_torch.search.hillclimb import hill_climb

        s = self.cfg["search"]
        self.scorer = BicScorer(self.dataset, max_parents=self.cfg["max_parents"],
                                device=self.device)
        self.sampled_calls(self.scorer, "score", lambda adj, out: (adj, out))
        n = self.cfg["num_vertices"]
        return lambda init: hill_climb(self.scorer, n, init_adj=init,
                                       max_iters=s["hill_climb_iters"],
                                       score_chunk=s["score_chunk"])

    def reference_climb(self, data, dtype):
        from dags_vae_search_tpu_torch.search.hillclimb import hill_climb

        s, n = self.cfg["search"], self.cfg["num_vertices"]
        scorer = ref_bic.Scorer(data, dtype)
        return lambda init: hill_climb(scorer, n, init_adj=init, max_iters=s["hill_climb_iters"],
                                       score_chunk=s["score_chunk"])

    def instrument(self, spans, kernels) -> list:
        from dags_vae_search_tpu_torch.ops import bic_kernel

        return [(self.scorer, "score", lambda fn: spans.wrap("score", fn)),
                (bic_kernel, "_launch_scores_wide",
                 _climbs.record(kernels, "score_wide", _score_launch))]

    def release(self) -> None:
        self.scorer = None

    def sample_check(self, data, dtype) -> tuple:
        """Served and reference scores of the sampled candidates."""
        if not self.samples:
            return np.zeros(0), np.zeros(0)
        adj = np.concatenate([a for a, _ in self.samples])
        served = np.concatenate([s for _, s in self.samples]).astype(np.float64)
        return served, ref_bic.structure_scores(data, adj, dtype)


def _score_launch(strides_t, q, codes_cm, w, *rest) -> dict:
    """The score entry's launch sizes: (candidate, node) rows, nodes, unique
    rows, the codes' bytes and the filled parent slots."""
    return {"rows": strides_t.shape[0] * strides_t.shape[1], "n": strides_t.shape[1],
            "unique": w.shape[0], "code_bytes": codes_cm.numel() * codes_cm.element_size(),
            "filled": (strides_t > 0).sum()}
