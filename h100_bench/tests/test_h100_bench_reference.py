"""The plain reference against brute force: BIC scores from counts made by
hand in Python, the best single move by scoring every move's whole
structure, and the inputs' generators' guarantees."""

import itertools
import math

import numpy as np
import pytest
import torch

from h100_bench import inputs
from h100_bench.reference import bic


def brute_family(codes, cards, child, parents, q_cap):
    q = math.prod(int(cards[p]) for p in parents)
    if q > q_cap:
        return -math.inf
    joint, marg = {}, {}
    for row in codes:
        cfg = tuple(int(row[p]) for p in parents)
        joint[cfg, int(row[child])] = joint.get((cfg, int(row[child])), 0) + 1
        marg[cfg] = marg.get(cfg, 0) + 1
    ll = sum(c * math.log(c / marg[cfg]) for (cfg, _), c in joint.items())
    return ll - (int(cards[child]) - 1) * q * math.log(len(codes)) / 2


@pytest.fixture
def data():
    codes, cards, _ = inputs.simulate(inputs.rng_for(3, "network"), inputs.rng_for(3, "data"),
                                      5, 6, 4, 3, 200)
    return codes, cards


def test_family_scores_match_brute_force(data):
    codes, cards = data
    ref = bic.Data(codes, cards, q_cap=12, max_parents=4, device="cpu")
    fams = [(0, []), (1, [0]), (2, [0, 1]), (3, [4, 2, 1]), (4, [0, 1, 2, 3])]
    got = bic.family_scores(ref, [f[0] for f in fams], bic.padded([f[1] for f in fams]))
    want = [brute_family(codes, cards, c, ps, 12) for c, ps in fams]
    for g, w in zip(got, want):
        assert (g == w == -math.inf) or math.isclose(g, w, rel_tol=1e-12)
    assert np.isinf(got).any() and np.isfinite(got).any()  # both kinds covered


def test_structure_scores_sum_families_and_keep_the_caps(data):
    codes, cards = data
    ref = bic.Data(codes, cards, q_cap=4096, max_parents=2, device="cpu")
    adj = np.zeros((2, 5, 5))
    adj[:, 0, 1] = adj[:, 1, 2] = 1
    adj[1, [0, 1, 3], 4] = 1  # three parents: over the cap
    got = bic.structure_scores(ref, adj)
    want = sum(brute_family(codes, cards, y, list(np.flatnonzero(adj[0, :, y])), 4096)
               for y in range(5))
    assert math.isclose(got[0], want, rel_tol=1e-12)
    assert got[1] == -math.inf


def test_bfloat16_scores_drift(data):
    codes, cards = data
    ref = bic.Data(codes, cards, q_cap=4096, max_parents=4, device="cpu")
    adj = np.zeros((1, 5, 5))
    adj[0, 0, 1] = 1
    exact = bic.structure_scores(ref, adj)[0]
    low = bic.structure_scores(ref, adj, torch.bfloat16)[0]
    assert abs(low - exact) / abs(exact) > 1e-4


def brute_best_move(ref, adj):
    a = adj > 0
    n = a.shape[0]
    base = bic.structure_scores(ref, a[None].astype(float))[0]
    best = -math.inf
    for x, y in itertools.permutations(range(n), 2):
        trials = []
        if not a[x, y] and not a[y, x]:
            t = a.copy()
            t[x, y] = True
            trials.append(t)
        if a[x, y]:
            t = a.copy()
            t[x, y] = False
            trials.append(t)
            t = t.copy()
            t[y, x] = True
            trials.append(t)
        for t in trials:
            if not bic.is_acyclic(t):
                continue
            s = bic.structure_scores(ref, t[None].astype(float))[0]
            if not np.isfinite(s):
                continue
            best = max(best, math.inf if not np.isfinite(base) else s - base)
    return best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_single_move_matches_every_move(data, seed):
    codes, cards = data
    ref = bic.Data(codes, cards, q_cap=9, max_parents=3, device="cpu")
    adj = inputs.random_dag(inputs.rng_for(seed, "dag"), 5, 6, 3)
    got = bic.best_single_move(ref, adj)
    want = brute_best_move(ref, adj)
    assert (got == want) or math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-9)


def test_inputs_keep_their_guarantees():
    rng = inputs.rng_for(2**31 + 7, "x")
    adj = inputs.random_dag(rng, 12, 20, 3)
    assert adj.sum() == 20 and bic.is_acyclic(adj) and adj.sum(0).max() <= 3
    labels, corpus = inputs.corpus(rng, 9, 16, 0.4, 2)
    assert np.all(np.triu(corpus, 1) == corpus) and corpus.sum(1).max() <= 2
    assert all(sorted(row) == list(range(9)) for row in labels.tolist())
    codes, cards, truth = inputs.simulate(rng, rng, 7, 9, 8, 4, 50)
    assert truth.sum() == 9 and bic.is_acyclic(truth)
    assert np.all(codes < cards[None, :]) and cards.min() >= 2 and cards.max() <= 4

    def draw(network, cases):
        return inputs.simulate(inputs.rng_for(network, "n"), inputs.rng_for(cases, "c"),
                               7, 9, 8, 4, 50)

    assert np.array_equal(draw(5, 6)[0], draw(5, 6)[0])
    # one network, other cases: the same states and DAG, other rows
    (a, cards_a, truth_a), (b, cards_b, truth_b) = draw(5, 6), draw(5, 7)
    assert np.array_equal(cards_a, cards_b) and np.array_equal(truth_a, truth_b)
    assert not np.array_equal(a, b)
