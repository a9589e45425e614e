"""The port's tracer (``utils/profiling.py``): spans and counters on the
profiler's clock, off (one flag check, nothing recorded) outside a profiler
session, and the counters the structure climbs and the decode keep."""

import ast
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
from dags_vae_search_tpu_torch.models.pace_vae import make_model
from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
from dags_vae_search_tpu_torch.search import delta_hillclimb, hillclimb
from dags_vae_search_tpu_torch.utils import profiling

PORT = Path(__file__).resolve().parent.parent / "dags_vae_search_tpu_torch"


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _dataset(n: int, seed: int = 0) -> DiscreteDataset:
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, 4, size=n).astype(np.int32)
    codes = np.stack([rng.integers(0, c, size=400) for c in cards], axis=1).astype(np.int32)
    # a chain of dependencies, so that the climbs have moves to make
    for j in range(1, n):
        copy = rng.random(400) < 0.7
        codes[copy, j] = codes[copy, j - 1] % cards[j]
    return DiscreteDataset(codes, cards, [f"x{i}" for i in range(n)])


class Untouchable:
    """A counter value whose every use raises: a counter that is off never
    looks at what it is given."""

    def __getattr__(self, name):
        raise AssertionError(f"read {name}")

    def __add__(self, other):
        raise AssertionError("added")

    __radd__ = __add__


def test_off_calls_no_record_function_and_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called outside a profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with _session():
        pass  # a finished session: the record is its (empty) one
    before = profiling.snapshot()
    assert before == {"spans": [], "counts": {}}
    with profiling.span("outside"), profiling.span("device", device=True):
        profiling.count("outside", Untouchable())
    assert profiling.span("a") is profiling.span("b", device=True)  # one shared no-op
    # a whole climb with its spans and counters, off; the dense climb does
    # not even make its counters' values (a slice of ``ok`` a chunk)
    scorer = BicScorer(_dataset(4), max_parents=2, device="cpu")
    monkeypatch.setattr(profiling, "count", refuse)
    hillclimb.hill_climb(scorer, 4, score_chunk=32)
    assert profiling.snapshot() == before


def test_on_nests_spans_with_self_times_on_the_profiler_clock():
    with _session() as prof:
        with profiling.span("outer"):
            torch.ones(8) @ torch.ones(8)
            with profiling.span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with profiling.span("inner"):
                pass
        with profiling.span("second"):
            pass
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("outer", -1), ("inner", 0), ("inner", 0), ("second", -1)]
    outer, a, b, second = spans
    assert outer["start_ns"] <= a["start_ns"] <= a["end_ns"] <= b["start_ns"] <= b["end_ns"]
    assert b["end_ns"] <= outer["end_ns"] <= second["start_ns"]
    dur = [s["end_ns"] - s["start_ns"] for s in spans]
    assert outer["self_ns"] == dur[0] - dur[1] - dur[2] >= 0
    assert [s["self_ns"] for s in spans[1:]] == dur[1:]
    assert all(s["device_ms"] is None for s in spans)  # no CUDA events on the CPU
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("outer", "inner", "second")), key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [s["name"] for s in spans]
    for e, s in zip(events, spans):
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000  # 1 ms
        assert abs(e.end_ns() - s["end_ns"]) < 1_000_000


def test_count_keeps_a_tensor_unread_until_the_snapshot(monkeypatch):
    with _session():
        for name in ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, Untouchable.__add__)
        profiling.count("rows", 3)
        profiling.count("rows", 4.5)
        profiling.count("useful", torch.tensor([True, False, True]))
        profiling.count("useful", torch.tensor([1, 1]))
        monkeypatch.undo()
    assert profiling.snapshot()["counts"] == {"rows": 7.5, "useful": 4.0}


def test_a_session_clears_the_last_one():
    with _session():
        with profiling.span("first"):
            profiling.count("n", 1)
    assert [s["name"] for s in profiling.snapshot()["spans"]] == ["first"]
    with _session():
        profiling.count("m", 2)
        with profiling.span("second"):
            pass
    snap = profiling.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["second"]
    assert snap["counts"] == {"m": 2.0}


def _feasible_moves(adj: np.ndarray) -> int:
    """Single-edge moves of ``adj`` that leave a DAG, by brute force:
    additions of a new edge between two unlinked nodes, every deletion, and
    reversals."""

    def acyclic(a):
        n = a.shape[0]
        done, stack = set(), set()

        def visit(u):
            if u in stack:
                return False
            if u in done:
                return True
            stack.add(u)
            ok = all(visit(v) for v in np.flatnonzero(a[u]))
            stack.discard(u)
            done.add(u)
            return ok

        return all(visit(u) for u in range(n))

    n, total = adj.shape[0], 0
    for x, y in itertools.permutations(range(n), 2):
        trial = adj.copy()
        if adj[x, y]:
            total += 1  # the deletion
            trial[x, y], trial[y, x] = 0, 1
            total += acyclic(trial)  # the reversal
        elif not adj[y, x]:
            trial[x, y] = 1
            total += acyclic(trial)  # the addition
    return total


def test_dense_climb_counts_rows_scored_and_feasible_moves(monkeypatch):
    # n = 4: 48 move slots in windows of 32, the second shifted back to
    # slot 16: 64 rows a step, 48 of them new
    scorer = BicScorer(_dataset(4), max_parents=2, device="cpu")
    seen = []
    candidates = hillclimb._move_candidates

    def keep(adj):
        seen.append(adj.numpy().copy())
        return candidates(adj)

    monkeypatch.setattr(hillclimb, "_move_candidates", keep)
    init = np.zeros((4, 4), np.float32)
    init[0, 2] = init[3, 1] = 1.0
    with _session():
        res = hillclimb.hill_climb(scorer, 4, init_adj=init, score_chunk=32)
    counts = profiling.snapshot()["counts"]
    assert res.iterations >= 1 and len(seen) == res.iterations + res.converged
    assert counts["climb.rows_scored"] == 64 * len(seen)
    assert counts["climb.moves_feasible"] == sum(_feasible_moves(a) for a in seen)


def test_delta_climb_counts_families_and_moves():
    fam = FamilyBatchScorer(_dataset(8, seed=3), max_parents=3, device="cpu")
    with _session():
        res = delta_hillclimb.delta_hill_climb(fam, 8, chunk=64, accept_batch=4)
    snap = profiling.snapshot()
    assert res.iterations > 0
    assert snap["counts"]["delta.families"] == res.num_evals
    assert snap["counts"]["delta.moves"] == res.iterations
    names = {s["name"] for s in snap["spans"]}
    assert {"climb", "delta.frontier", "delta.closure", "delta.build", "family",
            "family.upload", "family.launch", "family.reduce", "family.read"} <= names
    assert set(res.profile) == {"score_dispatch_s", "closure_s", "candidate_build_s"}


@pytest.mark.parametrize("readout", [{}, {"edge_readout": True, "edge_readout_rank": 2}],
                         ids=["plain", "rank_readout"])
def test_decode_builds_its_cache_once_a_call_and_runs_each_position_once(readout):
    model = make_model(0, "cpu", num_real_vertices=5, real_label_cardinality=5, embed_size=8,
                       num_heads=2, num_layers=2, latent_size=8, fc_hidden=8, **readout)
    z = torch.randn(6, 8, generator=torch.Generator().manual_seed(0))
    with _session():
        decode_to_labeled(model, z, torch.Generator().manual_seed(1))
        decode_to_labeled(model, z[:4], torch.Generator().manual_seed(2), temperature=1e-4)
    snap = profiling.snapshot()
    spans, n = snap["spans"], model.max_n
    names = [s["name"] for s in spans]
    assert names.count("decode") == names.count("decode.memory") == 2
    assert names.count("decode.model") == 2 * (n - 2)  # a slot each, 2 .. N - 1
    decode = [i for i, s in enumerate(spans) if s["name"] == "decode"]
    assert [s["parent"] for s in spans if s["name"] == "decode.memory"] == decode
    counts = snap["counts"]
    assert counts["decode.rows"] == 10
    assert counts["decode.positions"] / counts["decode.rows"] == n - 1


def _span_names() -> list:
    names = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", None)) == "span" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.append(node.args[0].value)
    return names


def test_no_span_of_the_port_takes_the_benchmark_s_prefix():
    names = _span_names()
    assert {"decode.model", "climb", "family.read", "train_chunk"} <= set(names)
    assert not [n for n in names if n.startswith("bench.")]


@pytest.mark.parametrize("device", [False, True])
def test_a_span_left_open_by_an_exception_still_closes(device):
    with _session():
        with pytest.raises(ValueError):
            with profiling.span("failing", device=device):
                raise ValueError("inside")
        with profiling.span("after"):
            pass
    spans = profiling.snapshot()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [("failing", -1), ("after", -1)]
    assert all(s["end_ns"] >= s["start_ns"] for s in spans)
