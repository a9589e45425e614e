"""What the two structure-climb generators share: the simulated data, a
unit of one climb with restarts from a seed-drawn DAG, the records of every
climb and of a sample of the scorer's calls, and the check of both against
the reference."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import common, inputs
from h100_bench.reference import bic as ref_bic


def record(kernels: dict, key: str, summary):
    """A wrapper factory that keeps ``summary(*args)`` of each launch: the
    sizes its roofline bound needs (device scalars are read once the window
    has closed)."""

    def factory(fn):
        def wrapped(*args, **kwargs):
            kernels.setdefault(key, []).append(summary(*args, **kwargs))
            return fn(*args, **kwargs)

        return wrapped

    return factory


def _take(x, rows: np.ndarray) -> np.ndarray:
    """Rows ``rows`` of a tensor or array, on the host."""
    if torch.is_tensor(x):
        return x.index_select(0, torch.as_tensor(rows, device=x.device)).cpu().numpy()
    return np.asarray(x)[rows]


class ClimbTraffic:
    """Subclasses give ``make_climb()`` (the climb of one start, through the
    program) and ``sample_check(data, dtype)``."""

    def __init__(self, cfg: dict, params: dict, seed: int, device):
        self.cfg, self.params, self.seed, self.device = cfg, params, seed, device
        self.counts: dict = {}
        self.codes, self.cards = common.make_data(cfg, seed)
        self.dataset = common.dataset(self.codes, self.cards)
        self.unique = common.unique_rows(self.codes)
        self.check_rng = inputs.rng_for(seed, "check")
        self.samples: list = []
        self.sampling = False
        self.climbs: list = []
        self._climb = self.make_climb()
        self._climb(self._start(inputs.rng_for(seed, "warm")))  # warm: every shape of a climb
        self.sampling = True

    def _start(self, rng: np.random.Generator) -> np.ndarray:
        """A feasible start: a random DAG of n - 1 to 2n edges under the
        in-degree cap, less random parents of any node whose parent
        configurations would exceed q_cap."""
        n = self.cfg["num_vertices"]
        adj = inputs.random_dag(rng, n, int(rng.integers(n - 1, 2 * n + 1)),
                                self.cfg["max_parents"])
        for y in range(n):
            ps = list(np.flatnonzero(adj[:, y]))
            while np.prod(self.cards[ps]) > self.cfg["q_cap"]:
                adj[ps.pop(int(rng.integers(len(ps)))), y] = 0.0
        return adj

    def sampled_calls(self, obj, attr: str, keep):
        """Wrap ``obj.attr`` so that each call in the window keeps a
        seed-drawn sample of its rows: ``keep(args..., out)`` gives (host
        inputs, host outputs) of the rows picked."""
        fn = getattr(obj, attr)
        per_call = int(self.params["check_rows_per_call"])
        share = float(self.params["check_call_share"])

        def wrapped(*args):
            out = fn(*args)
            if self.sampling and self.check_rng.random() < share:
                rows = common.pick_rows(self.check_rng, len(args[0]), per_call)
                picked = [_take(a, rows) for a in args]
                self.samples.append(keep(*picked, _take(out, rows)))
            return out

        setattr(obj, attr, wrapped)

    def climb(self, init):
        res = self._climb(init)
        if self.sampling:
            self.climbs.append(res)
        return res

    def unit(self, k: int) -> float:
        from dags_vae_search_tpu_torch.search.hillclimb import climb_with_restarts

        s = self.cfg["search"]
        rng = inputs.rng_for(self.seed, f"unit{k}")
        first = self.climb(self._start(rng))
        res = climb_with_restarts(self.climb, rng, restarts=s["hill_climb_restarts"],
                                  max_parents=self.cfg["max_parents"], first=first,
                                  tie_stop=s["hill_climb_tie_stop"])
        self.counts["moves"] = self.counts.get("moves", 0) + res.iterations
        self.counts["unique_rows"] = self.unique
        self.counts.setdefault("final_dags", []).append(res.best_adj)
        return float(res.iterations)

    def control(self) -> dict:
        """The control's numbers: the reference at bfloat16 in the
        program's scorer's place, scoring the sampled candidates and
        re-scoring the climbs, then driving one unit of the program's climbs
        itself; the climbs it finishes judged as the program's are."""
        data = common.reference_data(self.cfg, self.codes, self.cards, self.device)
        scored = self.check("bf16")
        climb = self.reference_climb(data, torch.bfloat16)
        self.climbs, self._climb = [], climb
        self.unit(-1)
        return {"control": scored, "control_climbs": self.check_climbs(data, "bf16")}

    def check(self, prec: str) -> list:
        dtype = torch.float64 if prec == "fp32" else torch.bfloat16
        data = common.reference_data(self.cfg, self.codes, self.cards, self.device)
        served, ref = self.sample_check(data, torch.float64)
        if prec != "fp32":  # the control's scores in the program's place
            served = self.sample_check(data, dtype)[1]
        both = np.isfinite(served) & np.isfinite(ref)
        mismatch = int((np.isfinite(served) != np.isfinite(ref)).sum())
        score_err = np.abs(served[both] - ref[both]) / np.abs(ref[both])

        return [
            {"name": "score_rel_err", "value": float(score_err.max()) if score_err.size else 0.0},
            {"name": "score_feasibility_mismatches", "value": float(mismatch)},
        ] + self.check_climbs(data, prec)

    def check_climbs(self, data, prec: str) -> list:
        """Every climb finished in the window (or a seed-drawn sample):
        its claimed score against its float64 re-score (the control's
        claims re-scored at its own precision), acyclicity, the in-degree
        cap, and the best single move it left where it converged."""
        dtype = torch.float64 if prec == "fp32" else torch.bfloat16
        picked = self.climbs
        most = int(self.params["check_climbs"])
        if len(picked) > most:
            idx = common.pick_rows(self.check_rng, len(picked), most)
            picked = [picked[i] for i in idx]
        adjs = np.stack([c.best_adj for c in picked])
        claimed = np.array([c.best_score for c in picked])
        if prec != "fp32":
            claimed = ref_bic.structure_scores(data, adjs, dtype)
        rescored = ref_bic.structure_scores(data, adjs)
        climb_err = [ref_bic.rel_err(a, b) for a, b in zip(claimed, rescored)]
        broken = sum(not ref_bic.is_acyclic(a) for a in adjs)
        broken += int(((adjs > 0).sum(axis=1) > self.cfg["max_parents"]).sum())
        left = [ref_bic.best_single_move(data, c.best_adj) for c in picked if c.converged]
        return [
            {"name": "climb_score_rel_err", "value": float(np.max(climb_err))},
            {"name": "climb_structure_faults", "value": float(broken)},
            {"name": "climb_gain_left", "value": float(max(left)) if left else 0.0},
        ]
