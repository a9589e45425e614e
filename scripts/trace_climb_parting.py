"""Where the dense climbs of ``chip_smoke.py`` part between the two ways
``BicScorer`` can score on the card.

Runs the climbs of phases 9 (alarm, with the registry's restarts) and 11
(barley at 16 states, 20 steps) once on the path before the score entry
(the fused entry's counts reduced by ``bic_torch.node_scores_from_counts``)
and once through the score entry, recording every step's chosen move, and
reports the first step where the two choose differently: both moves'
float32 scores on each path, their float64 exact scores, and whether the two
graphs are Markov equivalent (same skeleton, same v-structures).  Needs one
CUDA card; prints one JSON line a climb and writes them to the file named by
the first argument, if any:

    python3 scripts/trace_climb_parting.py [out.json]
"""
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from dags_vae_search_tpu_torch.experiments.registry import REGISTRY  # noqa: E402
from dags_vae_search_tpu_torch.scoring.bic import BicScorer  # noqa: E402
from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem  # noqa: E402
from dags_vae_search_tpu_torch.search import hillclimb  # noqa: E402


def traced_climb(scorer, n, init_adj, max_iters, chunk, log):
    """``hillclimb.hill_climb``'s steps (scored in its windows of ``chunk``
    moves, the lowest index winning a tie), each step's move, score and
    runner-up appended to ``log`` as one list."""
    dev = scorer.device
    adj = torch.zeros((n, n), device=dev) if init_adj is None else torch.as_tensor(
        np.asarray(init_adj), dtype=torch.float32, device=dev)
    total = 3 * n * n
    chunk = min(chunk, total)
    current = float(scorer.score(adj[None])[0])
    steps = []
    for it in range(max_iters):
        moves = hillclimb._move_candidates(adj)
        full = torch.full((total,), -float("inf"), device=dev)
        for start in range(0, total, chunk):
            start = min(start, total - chunk)
            cands = moves[start:start + chunk]
            ok = hillclimb._feasible(adj, cands, offset=start)
            full[start:start + chunk] = torch.where(ok, scorer.score(cands), -torch.inf)
        order = torch.argsort(full, descending=True, stable=True)[:2].tolist()
        k = order[0]
        best = float(full[k])
        steps.append({"init": init_adj is not None and it == 0, "k": k, "score": best,
                      "second": order[1], "second_score": float(full[order[1]]),
                      "state": adj.nonzero().tolist()})
        if best <= current + 1e-6:
            break
        current = best
        adj = moves[k]
    log.append(steps)
    return hillclimb.HillClimbResult(best_score=current, best_adj=adj.cpu().numpy(),
                                     iterations=len(steps) - 1, num_evals=0,
                                     history=[s["score"] for s in steps])


def vstructs(a):
    a = a > 0
    n = a.shape[0]
    out = set()
    for c in range(n):
        ps = np.flatnonzero(a[:, c])
        for i in range(len(ps)):
            for j in range(i + 1, len(ps)):
                x, y = ps[i], ps[j]
                if not a[x, y] and not a[y, x]:
                    out.add((x, y, c))
    return out


def markov_equivalent(a, b):
    sa, sb = (a > 0) | (a > 0).T, (b > 0) | (b > 0).T
    return bool(np.array_equal(sa, sb) and vstructs(a) == vstructs(b))


def move_name(k, n):
    kind = ("add", "delete", "reverse")[k // (n * n)]
    a, b = divmod(k % (n * n), n)
    return f"{kind} {a}->{b}"


def trace(label, scorer, n, run):
    """``run(log)`` on both paths; the first step where they part."""
    logs = {}
    for path in ("parent", "change"):
        log = []
        with cs.parent_path(scorer) if path == "parent" else contextlib.nullcontext():
            res = run(log)
        logs[path] = (log, res)
    pl, cl = logs["parent"][0], logs["change"][0]
    out = {"label": label, "climbs": [len(pl), len(cl)],
           "parent_best": logs["parent"][1].best_score, "change_best": logs["change"][1].best_score}
    for ci, (ps, cs_) in enumerate(zip(pl, cl)):
        if ps[0]["state"] != cs_[0]["state"]:
            out["parting"] = {"climb": ci, "step": 0, "why": "different start"}
            break
        for si, (a, b) in enumerate(zip(ps, cs_)):
            if a["k"] != b["k"]:
                state = torch.zeros((n, n), device="cuda")
                for u, v in a["state"]:
                    state[u, v] = 1.0
                moves = hillclimb._move_candidates(state)
                two = moves[[a["k"], b["k"]]]
                with cs.parent_path(scorer):
                    f_parent = scorer.score(two).tolist()
                f_change = scorer.score(two).tolist()
                exact = scorer.score_exact(two).tolist()
                host = scorer.score_exact_sparse(two.cpu().numpy()).tolist()
                out["parting"] = {
                    "climb": ci, "step": si, "state_edges": a["state"],
                    "parent_move": move_name(a["k"], n), "change_move": move_name(b["k"], n),
                    "parent_k": a["k"], "change_k": b["k"],
                    "f32_parent_path": f_parent, "f32_score_entry": f_change,
                    "float64_exact": exact, "float64_host": host,
                    "markov_equivalent": markov_equivalent(two[0].cpu().numpy(), two[1].cpu().numpy()),
                    "parent_second": [move_name(a["second"], n), a["second_score"]],
                    "change_second": [move_name(b["second"], n), b["second_score"]],
                }
                break
        if "parting" in out:
            break
    print(json.dumps(out), flush=True)
    return out


print(cs.nvidia_smi("name,power.limit"))
results = []
cfg = REGISTRY["alarm"]
_, ds = make_synthetic_problem(cfg.name, num_cases=cfg.simulate_cases,
                               max_card=cfg.simulate_max_card, seed=cfg.seed)
scorer = BicScorer(ds, max_parents=cfg.search.max_parents, device="cuda")
s, n = cfg.search, cfg.num_vertices
results.append(trace("alarm dense climb with restarts (phase 9)", scorer, n, lambda log: hillclimb.climb_with_restarts(
    lambda init: traced_climb(scorer, n, init, s.hill_climb_iters, 4096, log),
    np.random.default_rng(cfg.seed + 11), restarts=s.hill_climb_restarts,
    max_parents=s.max_parents, tie_stop=s.hill_climb_tie_stop)))
wcfg = REGISTRY[cs.WIDE_NAME]
_, wds = make_synthetic_problem(cs.WIDE_NAME, num_cases=wcfg.simulate_cases,
                                max_card=cs.WIDE_MAX_CARD, seed=wcfg.seed)
wscorer = BicScorer(wds, max_parents=wcfg.search.max_parents, device="cuda")
results.append(trace("barley dense climb (phase 11)", wscorer, wcfg.num_vertices,
                     lambda log: traced_climb(wscorer, wcfg.num_vertices, None, cs.WIDE_CLIMB_STEPS,
                                              cs.WIDE_CLIMB_CHUNK, log)))
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as fh:
        json.dump(results, fh)
