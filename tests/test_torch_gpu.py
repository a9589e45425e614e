"""Card tests: the CUDA contingency kernels (seg, fused and family entries)
against their plain versions, and the port on the card against the port on the CPU
(scoring, decode, the train step and the training loops).

Every test here needs a CUDA card and skips without one; whether there is a
card is decided inside the ``cuda`` fixture, never at import.  On the card:
``python -m pytest -m gpu tests/test_torch_gpu.py``.

The decode-attention kernel against its plain version (torch on the card):
float32 outputs to 1e-6 of their largest; with bfloat16 weight rounding a
weight one float32 ulp away may round to the next bfloat16 value, so to
2^-7 of the largest value, and all but 1% of the (row, head) pairs to 1e-6.

Counts are integer sums below 2^24, exact in float32 in any atomic order,
so kernel and plain version must agree bit for bit.  Scores sum the same
cells in another order on the card: rtol 1e-5.  A train step on the card
sums in another order than on the CPU (cuBLAS, float32 with TF32 off):
losses and parameters after three Adam steps to rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from dags_vae_search_tpu_torch.graphs import sampler
from dags_vae_search_tpu_torch.models import decode, pace_vae
from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch, decode_attention
from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import train as ttrain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(R, U, S, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-2, S + 3, size=(R, U)).astype(np.int32)
    seg[:, U - min(U, 7):] = S  # padding sentinel rows
    w = rng.integers(0, 50, size=U).astype(np.float32)
    return torch.as_tensor(w), torch.as_tensor(seg)


@pytest.mark.parametrize(
    "R,U,S",
    [
        (2 * 37, 4973, 512),  # the alarm search shape, two candidates
        (5, 257, 8),  # U not a multiple of the block
        (3, 1000, 16_384),  # 64 KB of bins: dynamic shared memory above 48 KB
        (2, 300, 58_112),  # the most bins a block can hold (227 KB)
        (1, 1, 1),
    ],
)
def test_kernel_equals_plain_version(cuda, R, U, S):
    """The entry on the route ``route()`` picks, and its narrow kernel
    launched directly whatever the route."""
    w, seg = _inputs(R, U, S)
    want = bic_kernel.contingency_counts_plain(w, seg, S)
    wide = bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S)) == "wide"
    before = (bic_kernel.contingency_counts_kernel.launches,
              bic_kernel.contingency_counts_wide.launches)
    got = bic_kernel.contingency_counts_kernel(w.to(cuda), seg.to(cuda), S)
    narrow = bic_kernel._launch(w.to(cuda), seg.to(cuda), S)
    torch.cuda.synchronize()
    assert (bic_kernel.contingency_counts_kernel.launches,
            bic_kernel.contingency_counts_wide.launches) == (before[0] + (not wide),
                                                             before[1] + wide)
    assert torch.equal(got.cpu(), want) and torch.equal(narrow.cpu(), want)


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    w, seg = _inputs(4, 64, 16)
    with pytest.raises(ValueError, match="contiguous"):
        bic_kernel.contingency_counts_kernel(w.to(cuda), seg.to(cuda).T.contiguous().T, 16)
    with pytest.raises(ValueError, match="on"):
        bic_kernel.contingency_counts_kernel(w, seg.to(cuda), 16)


def _fused_inputs(B, n, U, r_max, indegrees, seed=0):
    """Codes in [0, card) with one variable at r_max, integer weights, and
    candidates whose rows cycle through the given in-degrees."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, r_max + 1, size=n)
    cards[0] = r_max
    codes = (rng.integers(0, 2**30, size=(U, n)) % cards).astype(np.int32)
    w = rng.integers(1, 20, size=U).astype(np.float32)
    adj = np.zeros((B, n, n), np.float32)
    for r in range(B * n):
        b, i = divmod(r, n)
        k = min(indegrees[r % len(indegrees)], n - 1)
        adj[b, rng.choice(np.delete(np.arange(n), i), size=k, replace=False), i] = 1.0
    return torch.as_tensor(codes), torch.as_tensor(w), torch.as_tensor(cards.astype(np.int32)), \
        torch.as_tensor(adj)


DECODED_MIX = (8,) * 13 + tuple(range(8))  # ~65% at 8 parents, as decodes give


@pytest.mark.parametrize(
    "B,n,U,r_max,q_cap,indegrees",
    [
        (2, 37, 4973, 2, 256, DECODED_MIX),  # alarm search widths, both sides of SMALL_SPAN
        (3, 12, 3000, 4, 64, tuple(range(9))),  # cards up to 4, rows past q_cap
        (2, 10, 2000, 4, 4096, (0, 3, 8)),  # S = 16,384: dynamic shared memory
        (2, 9, 257, 3, 32, (0, 8, 2)),  # U not a multiple of 4 or of the warp
        (2, 6, 1, 2, 16, (0, 5, 1)),  # U = 1
        (2, 5, 500, 300, 4, (0, 1, 2)),  # r_max > 255: int32 codes
    ],
    ids=["alarm-widths", "card4", "q4096", "u257", "u1", "int32-codes"],
)
def test_fused_kernel_equals_plain_and_seg_kernel(cuda, B, n, U, r_max, q_cap, indegrees):
    codes_u, w, cards, adj = _fused_inputs(B, n, U, r_max, indegrees)
    strides, _ = bic_torch.parent_config_strides(adj, cards)
    strides_t = strides.transpose(1, 2).contiguous()
    codes_cm = bic_kernel.column_major_codes(codes_u, r_max)
    want = bic_kernel.contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    S = q_cap * r_max
    wide = bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, n)) == "wide"
    args = (strides_t.to(cuda), codes_cm.to(cuda), w.to(cuda), q_cap, r_max)
    before = (bic_kernel.contingency_counts_fused.launches,
              bic_kernel.contingency_counts_fused_wide.launches)
    got = bic_kernel.contingency_counts_fused(*args)
    narrow = bic_kernel._launch_fused(*args)  # the narrow kernel whatever the route
    torch.cuda.synchronize()
    assert (bic_kernel.contingency_counts_fused.launches,
            bic_kernel.contingency_counts_fused_wide.launches) == (before[0] + (not wide),
                                                                   before[1] + wide)
    assert torch.equal(got.cpu(), want) and torch.equal(narrow.cpu(), want)
    seg = bic_torch.cell_index(codes_u, strides, q_cap, r_max).reshape(B * n, U)
    by_seg = bic_kernel.contingency_counts_kernel(w.to(cuda), seg.to(cuda), q_cap * r_max)
    assert torch.equal(by_seg.cpu(), want)


def test_fused_alarm_data_equals_plain(cuda):
    _, ds = make_synthetic_problem("alarm")
    n = ds.num_variables
    _, adj = sampler.sample_er_batch(
        np.random.default_rng(2), 2, n, 2 * n, n, require_connected=False, max_in_degree=8
    )
    codes_u, w = np.unique(ds.codes, axis=0, return_counts=True)
    codes_u = torch.as_tensor(codes_u.astype(np.int32))
    strides, _ = bic_torch.parent_config_strides(torch.as_tensor(adj), torch.as_tensor(ds.cards))
    strides_t = strides.transpose(1, 2).contiguous()
    codes_cm = bic_kernel.column_major_codes(codes_u, 2)
    w = torch.as_tensor(w.astype(np.float32))
    want = bic_kernel.contingency_counts_fused_plain(strides_t, codes_cm, w, 256, 2)
    got = bic_kernel.contingency_counts_fused(strides_t.to(cuda), codes_cm.to(cuda), w.to(cuda), 256, 2)
    assert torch.equal(got.cpu(), want)


def test_fused_wrapper_rejects_what_it_cannot_take(cuda):
    codes_u, w, cards, adj = _fused_inputs(2, 6, 64, 2, (1, 2))
    strides, _ = bic_torch.parent_config_strides(adj, cards)
    codes_cm = bic_kernel.column_major_codes(codes_u, 2).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bic_kernel.contingency_counts_fused(strides.to(cuda).transpose(1, 2), codes_cm, w.to(cuda), 16, 2)
    with pytest.raises(ValueError, match="on"):
        bic_kernel.contingency_counts_fused(strides.to(cuda), codes_cm, w, 16, 2)
    misaligned = torch.zeros(6 * 64 + 1, dtype=torch.uint8, device=cuda)[1:].view(6, 64)
    with pytest.raises(ValueError, match="16-byte"):
        bic_kernel.contingency_counts_fused(strides.to(cuda), misaligned, w.to(cuda), 16, 2)


@pytest.mark.parametrize("name", ["asia", "alarm"])
def test_card_scorer_counts_equal_cpu(cuda, name):
    _, ds = make_synthetic_problem(name)
    n = ds.num_variables
    _, adj = sampler.sample_er_batch(
        np.random.default_rng(1), 32, n, 2 * n, n, require_connected=False, max_in_degree=8
    )
    card = BicScorer(ds, max_parents=8, device=cuda)
    cpu = BicScorer(ds, max_parents=8, device="cpu", impl="plain")
    assert card.impl == "kernel"
    c_card, q_card = card.counts(adj)
    c_cpu, q_cpu = cpu.counts(adj)
    assert torch.equal(c_card.cpu(), c_cpu) and torch.equal(q_card.cpu(), q_cpu)
    torch.testing.assert_close(card.score(adj).cpu(), cpu.score(adj), rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(card.score_exact(adj), cpu.score_exact(adj), rtol=1e-9)


def test_decode_on_card_keeps_its_invariants(cuda):
    kwargs = dict(num_real_vertices=7, real_label_cardinality=7, embed_size=16, num_heads=4,
                  num_layers=2, latent_size=16, fc_hidden=16, edge_readout=True)
    model = pace_vae.make_model(0, cuda, **kwargs)
    z = torch.randn(256, 16, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    rec, valid = decode.decode_to_labeled(
        model, z, torch.Generator(cuda).manual_seed(1), max_in_degree=3
    )
    assert valid.all()
    assert (torch.sort(rec.labels, dim=-1).values == torch.arange(7, device=cuda)).all()
    assert int(rec.adj.sum(dim=1).max()) <= 3
    assert torch.equal(rec.adj, torch.triu(rec.adj, diagonal=1))


TRAIN_MODEL = dict(num_real_vertices=6, real_label_cardinality=6, embed_size=16, num_heads=4,
                   num_layers=2, latent_size=16, fc_hidden=16, dropout=0.0, epsilon_scale=0.0,
                   edge_readout=True)


def _shift_invariant(name):
    # zero gradient in exact arithmetic: Adam turns its rounding noise into ±lr steps
    return name.endswith("k_proj.bias")


def test_train_steps_on_card_match_cpu(cuda):
    assert not torch.backends.cuda.matmul.allow_tf32
    labels, adj = sampler.sample_er_batch(np.random.default_rng(0), 48, 6, 7, 6)
    runs = []
    for dev in ("cpu", cuda):
        model = pace_vae.make_model(0, dev, **TRAIN_MODEL)
        trainer = ttrain.Trainer(model, ttrain.TrainConfig(batch_size=16, learning_rate=1e-3))
        state = trainer.init_state(0)
        losses = []
        for i, clip_norm in enumerate((1.0, 1e9, 1e9)):  # the clip active on the first step
            trainer.config.clip_norm = clip_norm
            lb = torch.as_tensor(labels[16 * i:16 * (i + 1)], device=dev)
            ad = torch.as_tensor(adj[16 * i:16 * (i + 1)], device=dev)
            losses.append(trainer.compute_gradients(state, lb, ad).cpu())
            state = trainer.apply_gradients(state)
        runs.append((torch.stack(losses), model.state_dict()))
    (l_cpu, p_cpu), (l_card, p_card) = runs
    torch.testing.assert_close(l_card, l_cpu, rtol=1e-4, atol=1e-5)
    for name, value in p_cpu.items():
        if not _shift_invariant(name):
            torch.testing.assert_close(p_card[name].cpu(), value, rtol=1e-4, atol=1e-5,
                                       msg=name)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_chunked_loop_on_card_equals_per_step_loop(cuda, packed):
    labels, adj = sampler.sample_er_batch(np.random.default_rng(1), 70, 6, 7, 6)
    corpus = tdata.pack_corpus(labels, adj) if packed else tdata.Corpus(labels, adj)
    kwargs = dict(TRAIN_MODEL, dropout=0.1, epsilon_scale=0.01)
    runs = []
    for steps_per_call in (1, 3):
        config = ttrain.TrainConfig(batch_size=16, epochs=2, learning_rate=1e-3, log_every=0,
                                    steps_per_call=steps_per_call)
        trainer = ttrain.Trainer(pace_vae.make_model(0, cuda, **kwargs), config)
        state, hist = trainer.fit(trainer.init_state(3), corpus, log=lambda s: None)
        runs.append((state.model.state_dict(), hist))
    (p1, h1), (p2, h2) = runs
    for key in ("loss_per_graph", "recon_per_graph", "kld_per_graph"):
        np.testing.assert_allclose([h[key] for h in h2], [h[key] for h in h1], rtol=1e-5)
    for name, value in p1.items():
        if not _shift_invariant(name):
            torch.testing.assert_close(p2[name], value, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("n", [5, 37, 70])
def test_dense_adj_on_card(cuda, n):
    dense = (np.random.default_rng(n).random((4, n, n)) < 0.3).astype(np.float32)
    packed = torch.as_tensor(np.packbits(dense.astype(np.uint8), axis=-1), device=cuda)
    got = ttrain._dense_adj(packed, n)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got.cpu(), torch.as_tensor(dense))


def test_sample_er_dags_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    labels, adj, ok = sampler.sample_er_dags(gen, 512, 12, 14, 12)
    assert labels.device.type == adj.device.type == ok.device.type == "cuda"
    assert torch.all(adj.sum(dim=(1, 2)) == 14)
    assert torch.equal(adj, torch.triu(adj, diagonal=1))
    from dags_vae_search_tpu_torch.graphs.dag import is_weakly_connected

    assert torch.equal(ok, is_weakly_connected(adj)) and float(ok.float().mean()) > 0.9
    assert torch.equal(torch.sort(labels, dim=1).values,
                       torch.arange(12, device=cuda, dtype=torch.int32).expand(512, 12))


def _alarm_families(fam, count, seed):
    """Families of the delta climb's shape: a child and up to max_parents
    parents padded with -1."""
    n = fam.dataset.num_variables
    rng = np.random.default_rng(seed)
    children = rng.integers(0, n, size=count).astype(np.int32)
    parents = np.full((count, fam.max_parents + 1), -1, np.int32)
    for i, y in enumerate(children):
        k = rng.integers(0, fam.max_parents + 2)
        parents[i, :k] = rng.choice(np.delete(np.arange(n), y), size=k, replace=False)
    return children, parents


def test_family_batch_scorer_on_card_equals_cpu(cuda):
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    _, ds = make_synthetic_problem("alarm")
    card = FamilyBatchScorer(ds, max_parents=8, q_cap=256, device=cuda)
    cpu = FamilyBatchScorer(ds, max_parents=8, q_cap=256, device="cpu")
    children, parents = _alarm_families(cpu, 512, seed=3)
    seg_card, q_card = card.cells(children, parents)
    seg_cpu, q_cpu = cpu.cells(children, parents)
    assert torch.equal(seg_card.cpu(), seg_cpu) and torch.equal(q_card.cpu(), q_cpu)
    S = card.q_cap * card.r_max
    before = bic_kernel.contingency_counts_kernel.launches
    counts_card = bic_kernel.contingency_counts_kernel(card._weights, seg_card, S)
    assert bic_kernel.contingency_counts_kernel.launches == before + 1
    assert torch.equal(counts_card.cpu(), bic_kernel.contingency_counts_plain(cpu._weights, seg_cpu, S))
    s_card, s_cpu = card.score(children, parents).cpu(), cpu.score(children, parents)
    assert torch.equal(torch.isinf(s_card), torch.isinf(s_cpu)) and torch.isinf(s_cpu).any()
    fin = torch.isfinite(s_cpu)
    torch.testing.assert_close(s_card[fin], s_cpu[fin], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("n", [300, 724])
def test_closure_blocked_on_card_equals_cpu(cuda, n):
    from dags_vae_search_tpu_torch.graphs.dag import attention_allowed
    from dags_vae_search_tpu_torch.ops.reachability import closure_blocked

    _, adj = sampler.sample_er_batch(np.random.default_rng(n), 2, n, 2 * n, n,
                                     require_connected=False)
    adj = torch.as_tensor(adj)
    want = closure_blocked(adj)
    got = closure_blocked(adj.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(attention_allowed(adj.to(cuda)).cpu(), attention_allowed(adj))


def test_exact_gp_fit_on_card_matches_cpu(cuda):
    from dags_vae_search_tpu_torch.surrogate.gp import ExactGP

    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 - 9000.0
    fits = [ExactGP(device=dev).fit(x, y, iters=50) for dev in ("cpu", cuda)]
    (cpu, card) = fits
    assert np.isfinite(card.final_nmll)
    # cuSOLVER and LAPACK factorise in another order; Adam carries it: rtol 1e-3
    for a, b in zip(card.params, cpu.params):
        assert float(a) == pytest.approx(float(b), rel=1e-3)
    xs = rng.normal(size=(64, 32)).astype(np.float32)
    mu_card, sd_card = card.predict_with_std(xs)
    mu_cpu, sd_cpu = cpu.predict_with_std(xs)
    np.testing.assert_allclose(mu_card, mu_cpu, rtol=1e-3)
    np.testing.assert_allclose(sd_card, sd_cpu, rtol=1e-2)


def test_hill_climb_on_card_matches_cpu(cuda):
    from dags_vae_search_tpu_torch.search.hillclimb import hill_climb

    _, ds = make_synthetic_problem("child")
    card = BicScorer(ds, max_parents=8, device=cuda)
    cpu = BicScorer(ds, max_parents=8, device="cpu", impl="plain")
    n = ds.num_variables
    got = hill_climb(card, n, max_iters=3)
    want = hill_climb(cpu, n, max_iters=3)
    # equal float32 scores of score-equivalent moves may break ties apart:
    # the histories agree, the graphs score the same in float64
    assert got.iterations == want.iterations == 3 and got.num_evals == want.num_evals
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5, atol=1e-3)
    exact = cpu.score_exact(np.stack([got.best_adj, want.best_adj]))
    assert exact[0] == pytest.approx(exact[1], rel=1e-9)


# ---- the wide-row route: S tiled over blocks -------------------------------

WIDE_TILE = bic_kernel.WIDE_TILE_BINS


def _launch_counts():
    return (bic_kernel.contingency_counts_kernel.launches,
            bic_kernel.contingency_counts_wide.launches,
            bic_kernel.contingency_counts_fused.launches,
            bic_kernel.contingency_counts_fused_wide.launches)


@pytest.mark.parametrize(
    "R,U,S",
    [
        (3, 1000, 65_536),  # q_cap 4,096 x 16 states
        (4, 257, WIDE_TILE + 1),  # one bin past a tile: two tiles
        (2, 1, WIDE_TILE + 1),  # U = 1
        (2, 300, 58_113),  # one bin past the narrow kernel, S odd
        (5, 300, 8),  # one tile, narrower than the tile
    ],
    ids=["s65536", "tile-plus-one", "u1", "past-narrow", "one-tile"],
)
def test_seg_wide_kernel_equals_plain_version(cuda, R, U, S):
    w, seg = _inputs(R, U, S)
    want = bic_kernel.contingency_counts_plain(w, seg, S)
    before = _launch_counts()
    got = bic_kernel.contingency_counts_wide(w.to(cuda), seg.to(cuda), S)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert _launch_counts() == (before[0], before[1] + 1, *before[2:])
    # the seg entry routes by bins: wide rows to the wide kernel
    wide = bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S)) == "wide"
    by_entry = bic_kernel.contingency_counts_kernel(w.to(cuda), seg.to(cuda), S)
    assert torch.equal(by_entry.cpu(), want)
    assert _launch_counts() == (before[0] + (not wide), before[1] + 1 + wide, *before[2:])


def _score_launch_counts():
    return (bic_kernel.node_scores_fused.launches, bic_kernel.node_scores_fused_wide.launches)


@pytest.mark.parametrize(
    "B,n,U,r_max,q_cap,indegrees",
    [
        (2, 6, 1500, 16, 4096, (0, 3, 5)),  # S = 65,536
        (2, 5, 1, 16, 4096, (0, 1, 4)),  # U = 1
        (2, 7, 700, 5, 3277, (0, 2, 6)),  # S = tile + 1, rows past q_cap
        (2, 5, 500, 300, 220, (0, 1, 2)),  # r_max > 255: int32 codes, S = 66,000
    ],
    ids=["s65536", "u1", "tile-plus-one", "int32-codes"],
)
def test_fused_wide_kernel_equals_plain(cuda, B, n, U, r_max, q_cap, indegrees):
    codes_u, w, cards, adj = _fused_inputs(B, n, U, r_max, indegrees)
    strides, _ = bic_torch.parent_config_strides(adj, cards)
    strides_t = strides.transpose(1, 2).contiguous()
    codes_cm = bic_kernel.column_major_codes(codes_u, r_max)
    args = (strides_t.to(cuda), codes_cm.to(cuda), w.to(cuda), q_cap, r_max)
    want = bic_kernel.contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    before = _launch_counts()
    got = bic_kernel.contingency_counts_fused_wide(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert _launch_counts() == (*before[:3], before[3] + 1)
    S = q_cap * r_max
    wide = bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, n)) == "wide"
    assert torch.equal(bic_kernel.contingency_counts_fused(*args).cpu(), want)
    assert _launch_counts() == (*before[:2], before[2] + (not wide), before[3] + 1 + wide)
    seg = bic_torch.cell_index(codes_u, strides, q_cap, r_max).reshape(B * n, U)
    assert torch.equal(bic_kernel.contingency_counts_kernel(w.to(cuda), seg.to(cuda),
                                                            q_cap * r_max).cpu(), want)


def test_card_scorer_counts_wide_rows_as_the_cpu(cuda):
    _, ds = make_synthetic_problem("barley", num_cases=800, max_card=16)
    n = ds.num_variables
    _, adj = sampler.sample_er_batch(np.random.default_rng(4), 3, n, 2 * n, n,
                                     require_connected=False, max_in_degree=8)
    card = BicScorer(ds, max_parents=8, device=cuda)
    cpu = BicScorer(ds, max_parents=8, device="cpu", impl="plain")
    assert (card.q_cap, card.r_max) == (4096, 16)
    before = _launch_counts()
    c_card, q_card = card.counts(adj)
    c_cpu, q_cpu = cpu.counts(adj)
    assert torch.equal(c_card.cpu(), c_cpu) and torch.equal(q_card.cpu(), q_cpu)
    assert _launch_counts() == (*before[:3], before[3] + 1)
    np.testing.assert_allclose(card.score_exact(adj), cpu.score_exact(adj), rtol=1e-9)


@pytest.fixture
def link_dataset(tmp_path):
    """The link experiment's simulated dataset, as its runner makes it."""
    import dataclasses

    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
    from dags_vae_search_tpu_torch.experiments.runner import ExperimentRunner

    cfg = dataclasses.replace(REGISTRY["link"], dataset_csv=None)
    return ExperimentRunner(cfg, data_dir=str(tmp_path), device="cpu").scoring_dataset()


def test_link_scorer_counts_equal_cpu(cuda, link_dataset):
    n = link_dataset.num_variables
    _, adj = sampler.sample_connected_dags(np.random.default_rng(4), 4, n, 2 * n, n,
                                           max_in_degree=8)
    card = BicScorer(link_dataset, max_parents=8, device=cuda)
    cpu = BicScorer(link_dataset, max_parents=8, device="cpu", impl="plain")
    assert card.impl == "kernel" and n == 724
    before = bic_kernel.contingency_counts_fused.launches
    c_card, q_card = card.counts(adj)
    assert bic_kernel.contingency_counts_fused.launches == before + 1
    c_cpu, q_cpu = cpu.counts(adj)
    assert torch.equal(c_card.cpu(), c_cpu) and torch.equal(q_card.cpu(), q_cpu)
    torch.testing.assert_close(card.score(adj).cpu(), cpu.score(adj), rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(card.score_exact(adj), cpu.score_exact(adj), rtol=1e-9)


def test_link_family_chunk_on_card_equals_cpu(cuda, link_dataset):
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
    from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

    n = link_dataset.num_variables
    card = FamilyBatchScorer(link_dataset, max_parents=8, q_cap=256, device=cuda)
    cpu = FamilyBatchScorer(link_dataset, max_parents=8, q_cap=256, device="cpu")
    children, parents, _ = refresh_families(np.zeros((n, n), bool), range(6), 8)
    children, parents = np.asarray(children, np.int32), np.stack(parents)
    seg_card, _ = card.cells(children, parents)
    seg_cpu, _ = cpu.cells(children, parents)
    assert torch.equal(seg_card.cpu(), seg_cpu)
    S = card.q_cap * card.r_max
    before = bic_kernel.contingency_counts_kernel.launches
    got = bic_kernel.contingency_counts_kernel(card._weights, seg_card, S)
    assert bic_kernel.contingency_counts_kernel.launches == before + 1
    assert torch.equal(got.cpu(), bic_kernel.contingency_counts_plain(cpu._weights, seg_cpu, S))
    torch.testing.assert_close(card.score(children, parents).cpu(), cpu.score(children, parents),
                               rtol=1e-5, atol=0.0)


@pytest.fixture
def sachs_three_states():
    """Sachs with three-state variables: at ``max_parents`` 8, q_cap 4,096
    and S = 12,288 cells a row."""
    _, ds = make_synthetic_problem("sachs", num_cases=5000, max_card=3, seed=0)
    return ds


def test_sachs_three_state_family_table_on_card_equals_cpu(cuda, sachs_three_states):
    from dags_vae_search_tpu_torch.scoring.family_table import FamilyTableScorer

    ds = sachs_three_states
    card_scorer = BicScorer(ds, max_parents=8, device=cuda)
    assert (card_scorer.q_cap, card_scorer.r_max, ds.num_variables) == (4096, 3, 11)
    narrow = bic_kernel.route("fused", 4096 * 3,
                              bic_kernel.fused_warp_bytes(4096 * 3, 11)) == "narrow"
    before, scores_before = _launch_counts(), _score_launch_counts()
    card = FamilyTableScorer(ds, max_parents=8, base_scorer=card_scorer)
    # 2^11 masks in chunks of 1,024: two launches of the score entry on the
    # route route() picks, none of the count entries
    assert _launch_counts() == before
    assert _score_launch_counts() == (scores_before[0] + 2 * narrow,
                                      scores_before[1] + 2 * (not narrow))
    cpu = FamilyTableScorer(ds, max_parents=8, device="cpu")
    got, want = card._table_t.cpu().numpy(), cpu._table_t.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert finite.any() and (~finite).any()
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=0)
    _, adj = sampler.sample_er_batch(np.random.default_rng(5), 64, 11, 14, 11, max_in_degree=4)
    torch.testing.assert_close(card.score(adj).cpu(), cpu.score(adj), rtol=1e-5, atol=0.0)


def test_sachs_three_state_exact_search_on_card_equals_cpu(cuda, sachs_three_states):
    from dags_vae_search_tpu_torch.search.exact import exact_search

    ds = sachs_three_states
    card = BicScorer(ds, max_parents=8, device=cuda)
    cpu = BicScorer(ds, max_parents=8, device="cpu")
    narrow = bic_kernel.route("fused", 4096 * 3,
                              bic_kernel.fused_warp_bytes(4096 * 3, 11)) == "narrow"
    before, scores_before = _launch_counts(), _score_launch_counts()
    got = exact_search(card, 11, max_parents=6)
    # one chunk of 848 families per node through the score entry, on the
    # route route() picks
    assert _launch_counts() == before
    assert _score_launch_counts() == (scores_before[0] + 11 * narrow,
                                      scores_before[1] + 11 * (not narrow))
    want = exact_search(cpu, 11, max_parents=6)
    assert got.num_families == want.num_families == 9328
    # float32 family scores summed in another order: 1e-5; float64 re-scores 1e-9
    assert got.best_score == pytest.approx(want.best_score, rel=1e-5)
    exact = float(card.score_exact(got.best_adj[None])[0])
    assert exact == pytest.approx(float(cpu.score_exact(want.best_adj[None])[0]), rel=1e-9)
    assert exact == pytest.approx(float(cpu.score_exact_sparse(got.best_adj[None])[0]), rel=1e-9)


@pytest.fixture
def hepar2_four_states(tmp_path):
    """hepar2's simulated data with four-state variables, as its runner
    makes it: at ``max_parents`` 8, q_cap 4,096 and S = 16,384 cells a row."""
    import copy

    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
    from dags_vae_search_tpu_torch.experiments.runner import ExperimentRunner

    cfg = copy.deepcopy(REGISTRY["hepar2"])
    cfg.dataset_csv, cfg.simulate_max_card = None, 4
    return ExperimentRunner(cfg, data_dir=str(tmp_path), device="cpu").scoring_dataset()


def test_hepar2_four_states_both_routes_of_both_entries_equal_plain(cuda, hepar2_four_states):
    """Each entry's narrow kernel (launched directly), its wide kernel and
    the entry's own route equal the plain version; the launch counts follow
    ``route()``."""
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
    from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

    ds = hepar2_four_states
    n = ds.num_variables
    card = BicScorer(ds, max_parents=8, device=cuda)
    cpu = BicScorer(ds, max_parents=8, device="cpu", impl="plain")
    S = card.q_cap * card.r_max
    assert (n, card.q_cap, card.r_max, S) == (70, 4096, 4, 16_384)
    fused_wide = bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, n)) == "wide"
    seg_wide = bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S)) == "wide"

    # the fused entry: 4 candidates with hepar2's 123 edges
    _, adj = sampler.sample_connected_dags(np.random.default_rng(6), 4, n, 123, n,
                                           max_in_degree=8)
    strides, _ = bic_torch.parent_config_strides(torch.as_tensor(adj), cpu._cards)
    strides_t = strides.transpose(1, 2).contiguous()
    want = bic_kernel.contingency_counts_fused_plain(strides_t, cpu._codes_cm, cpu._weights,
                                                     card.q_cap, card.r_max)
    args = (strides_t.to(cuda), card._codes_cm, card._weights, card.q_cap, card.r_max)
    before = _launch_counts()
    narrow = bic_kernel._launch_fused(*args)
    wide = bic_kernel.contingency_counts_fused_wide(*args)
    routed = bic_kernel.contingency_counts_fused(*args)
    torch.cuda.synchronize()
    for got in (narrow, wide, routed):
        assert torch.equal(got.cpu(), want)
    assert _launch_counts() == (before[0], before[1], before[2] + (not fused_wide),
                                before[3] + 1 + fused_wide)

    # the seg entry: the first frontier's families of 6 children
    card_fam = FamilyBatchScorer(ds, max_parents=8, q_cap=4096, device=cuda)
    cpu_fam = FamilyBatchScorer(ds, max_parents=8, q_cap=4096, device="cpu")
    children, parents, _ = refresh_families(np.zeros((n, n), bool), range(6), 8)
    children, parents = np.asarray(children, np.int32), np.stack(parents)
    seg_card, _ = card_fam.cells(children, parents)
    seg_cpu, _ = cpu_fam.cells(children, parents)
    assert torch.equal(seg_card.cpu(), seg_cpu)
    want = bic_kernel.contingency_counts_plain(cpu_fam._weights, seg_cpu, S)
    before = _launch_counts()
    narrow = bic_kernel._launch(card_fam._weights, seg_card, S)
    wide = bic_kernel.contingency_counts_wide(card_fam._weights, seg_card, S)
    routed = bic_kernel.contingency_counts_kernel(card_fam._weights, seg_card, S)
    torch.cuda.synchronize()
    for got in (narrow, wide, routed):
        assert torch.equal(got.cpu(), want)
    assert _launch_counts() == (before[0] + (not seg_wide), before[1] + 1 + seg_wide,
                                before[2], before[3])

    # the family entry on the same families, and the scorer through it
    _check_family_routes(cuda, card_fam, cpu_fam, children, parents)
    torch.testing.assert_close(card_fam.score(children, parents).cpu(),
                               cpu_fam.score(children, parents), rtol=1e-5, atol=0.0)


# ---- the family entry: cells from parent lists, counted in the kernel -------


def _family_counts():
    return (bic_kernel.contingency_counts_family.launches,
            bic_kernel.contingency_counts_family_wide.launches)


def _check_family_routes(cuda, card_fam, cpu_fam, children, parents):
    """The family entry's narrow kernel (launched directly at each cluster
    size and three lane-private spans, where its block fits, and once with
    float32 weights), its wide kernel and its own route, each equal to the
    plain version bit for bit."""
    S = cpu_fam.q_cap * cpu_fam.r_max
    P = parents.shape[1]
    cpu_args = (*cpu_fam._families(children, parents), cpu_fam._codes_cm, cpu_fam._cards,
                cpu_fam._weights, cpu_fam.q_cap, cpu_fam.r_max)
    args = (*card_fam._families(children, parents), card_fam._codes_cm, card_fam._cards,
            card_fam._multiplicities, card_fam.q_cap, card_fam.r_max)
    want = bic_kernel.contingency_counts_family_plain(*cpu_args)
    need = bic_kernel.family_block_bytes(S, P)
    wide_route = bic_kernel.route("family", S, need) == "wide"
    before = _family_counts() + _launch_counts()
    got = [bic_kernel.contingency_counts_family(*args),
           bic_kernel.contingency_counts_family_wide(*args)]
    if need <= bic_kernel.MAX_SHARED_BYTES:
        got += [bic_kernel._launch_family(*args, cluster=c, private_span=span)
                for c in bic_kernel.FAMILY_CLUSTER_SIZES for span in (0, 16, 64)]
        got.append(bic_kernel._launch_family(*args[:4], card_fam._weights, *args[5:]))
    torch.cuda.synchronize()
    for counts in got:
        assert torch.equal(counts.cpu(), want)
    assert _family_counts() + _launch_counts() == (
        before[0] + (not wide_route), before[1] + 1 + wide_route, *before[2:])
    assert float(want.sum()) == cpu_fam.num_cases * len(children)


def _refresh_chunk(fam, seed, count):
    """Families of the delta climb's shapes: the first frontier of a few
    children and every refresh of a random DAG's nodes (up to max_parents
    parents), ``count`` of them."""
    from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

    n = fam.dataset.num_variables
    _, adj = sampler.sample_er_batch(np.random.default_rng(seed), 1, n, 2 * n, n,
                                     require_connected=False, max_in_degree=fam.max_parents)
    first = refresh_families(np.zeros((n, n), bool), range(min(n, 3)), fam.max_parents)[:2]
    final = refresh_families(adj[0] > 0, range(n), fam.max_parents)[:2]
    children = np.asarray(first[0] + final[0], np.int32)
    parents = np.stack(first[1] + final[1])
    keep = np.random.default_rng(seed).permutation(len(children))[:count]
    return children[keep], parents[keep]


@pytest.mark.parametrize(
    "name,max_card,q_cap,S",
    [("alarm", 2, 256, 512), ("sachs", 3, 4096, 12_288), ("hepar2", 4, 4096, 16_384),
     ("barley", 16, 4096, 65_536)],
    ids=["s512", "s12288", "s16384", "s65536"],
)
def test_family_kernel_both_routes_equal_plain(cuda, name, max_card, q_cap, S):
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    _, ds = make_synthetic_problem(name, num_cases=1500, max_card=max_card, seed=1)
    card = FamilyBatchScorer(ds, max_parents=8, q_cap=q_cap, device=cuda)
    cpu = FamilyBatchScorer(ds, max_parents=8, q_cap=q_cap, device="cpu")
    assert cpu.q_cap * cpu.r_max == S
    children, parents = _refresh_chunk(cpu, seed=2, count=600)
    _check_family_routes(cuda, card, cpu, children, parents)


def test_family_kernel_int32_codes_and_empty_slots_anywhere(cuda):
    """A 300-state variable (int32 column-major codes) and families whose
    empty slots sit between filled ones."""
    from dags_vae_search_tpu_torch.scoring.catalog import simulate_dataset
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    rng = np.random.default_rng(7)
    cards = np.array([300, 2, 3, 2, 3, 4])
    _, truth = sampler.sample_er_batch(rng, 1, 6, 7, 6)
    ds = simulate_dataset(rng, truth[0], cards, 3000)
    card = FamilyBatchScorer(ds, max_parents=4, q_cap=16, device=cuda)
    cpu = FamilyBatchScorer(ds, max_parents=4, q_cap=16, device="cpu")
    assert card._codes_cm.dtype == torch.int32
    children = rng.integers(0, 6, size=200).astype(np.int32)
    parents = np.full((200, 7), -1, np.int32)
    for i, y in enumerate(children):
        k = rng.integers(0, 5)
        parents[i, rng.choice(7, size=k, replace=False)] = rng.choice(
            np.delete(np.arange(6), y), size=k, replace=False)
    _check_family_routes(cuda, card, cpu, children, parents)


def test_family_wrapper_rejects_what_it_cannot_take(cuda):
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    _, ds = make_synthetic_problem("asia")
    fam = FamilyBatchScorer(ds, max_parents=3, device=cuda)
    children, parents = fam._families(np.array([0, 1], np.int32),
                                      np.array([[1, -1, -1, -1], [0, 2, -1, -1]], np.int32))
    args = dict(codes_cm=fam._codes_cm, cards=fam._cards, w=fam._weights, q_cap=fam.q_cap,
                r_max=fam.r_max)
    for entry in (bic_kernel.contingency_counts_family, bic_kernel.contingency_counts_family_wide):
        with pytest.raises(ValueError):  # not contiguous
            entry(children, parents.T.contiguous().T, **args)
        with pytest.raises(ValueError):  # two devices
            entry(children.cpu(), parents, **args)
        with pytest.raises(ValueError):  # no families: an empty grid
            entry(children[:0], parents[:0], **args)
        with pytest.raises(ValueError):  # a parent past n
            entry(children, torch.full_like(parents, 8), **args)


def test_family_batch_scorer_counts_through_the_family_entry_on_card(cuda):
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    _, ds = make_synthetic_problem("alarm")
    card = FamilyBatchScorer(ds, max_parents=8, q_cap=256, device=cuda)
    cpu = FamilyBatchScorer(ds, max_parents=8, q_cap=256, device="cpu")
    children, parents = _alarm_families(cpu, 4096, seed=5)
    before_seg, before = bic_kernel.contingency_counts_kernel.launches, _family_counts()
    got = card.score_chunked(children, parents, chunk=4096)
    assert _family_counts() == (before[0] + 1, *before[1:])
    assert bic_kernel.contingency_counts_kernel.launches == before_seg
    want = cpu.score_chunked(children, parents, chunk=4096)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0.0)


# ---- the family narrow kernel: a family's rows over a thread-block cluster --


def _split_families(fam, F, seed):
    """F families at alarm width: one family of 5 parents (F = 1), the
    refresh of one child with 4 parents (F = 36: 64 and 16 cells, both
    sides of the lane-private limit), else :func:`_refresh_chunk`'s families
    (0-8 parents) cycled to F."""
    from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

    n = fam.dataset.num_variables
    rng = np.random.default_rng(seed)
    if F in (1, 36):
        y = int(rng.integers(0, n))
        adj = np.zeros((n, n), bool)
        adj[rng.choice(np.delete(np.arange(n), y), size=4, replace=False), y] = True
        children, parents = refresh_families(adj, [y], fam.max_parents)[:2]
        children, parents = np.asarray(children, np.int32), np.stack(parents)
        assert len(children) == 36
        keep = np.argsort(-(parents >= 0).sum(1), kind="stable")[:F]
        return children[keep], parents[keep]
    children, parents = _refresh_chunk(fam, seed, count=10**6)
    return np.resize(children, F), np.resize(parents, (F, parents.shape[1]))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("F", [1, 36, 723, 4096])
def test_family_cluster_kernel_equals_plain_at_each_cluster_size(cuda, F, cluster):
    """The narrow kernel forced to ``cluster`` blocks a family, on alarm's
    binary data (U = 4,973 unique rows: not a multiple of 4, nor of any
    cluster's slice), uint8 codes, families on both sides of the
    lane-private limit, bit-equal to the plain version on the same card
    tensors; and the cluster size the wrapper picks is one of the four."""
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    _, ds = make_synthetic_problem("alarm")
    fam = FamilyBatchScorer(ds, max_parents=8, q_cap=256, device=cuda)
    U = fam._weights.shape[0]
    assert U % 4 and fam._codes_cm.dtype == torch.uint8
    children, parents = _split_families(fam, F, seed=F + cluster)
    spans = 2 ** ((parents >= 0).sum(1) + 1)
    if F > 1:
        assert spans.max() > bic_kernel.FAMILY_PRIVATE_SPAN >= spans.min()
    args = (*fam._families(children, parents), fam._codes_cm, fam._cards, fam._multiplicities,
            fam.q_cap, fam.r_max)
    want = bic_kernel.contingency_counts_family_plain(*args)
    got = bic_kernel._launch_family(*args, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    blocks, sms = bic_kernel._family_occupancy(torch.cuda.current_device(), 1, 512, 9,
                                               bic_kernel.FAMILY_PRIVATE_SPAN)
    assert blocks >= 1 and sms >= 1
    assert bic_kernel.family_cluster_size(F, U, blocks, sms) in bic_kernel.FAMILY_CLUSTER_SIZES


def test_family_cluster_kernel_raises_on_what_the_card_refuses(cuda):
    """A cluster of 32 blocks (past the card's largest) and of 0 blocks fail
    the launch and raise, with no fallback; the next launch is not hurt by
    the refused one.  int32 multiplicities off a 16-byte boundary are
    refused by the wrapper."""
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer

    _, ds = make_synthetic_problem("alarm")
    fam = FamilyBatchScorer(ds, max_parents=8, q_cap=256, device=cuda)
    children, parents = _split_families(fam, 36, seed=0)
    args = (*fam._families(children, parents), fam._codes_cm, fam._cards, fam._multiplicities,
            fam.q_cap, fam.r_max)
    for cluster in (32, 0):
        with pytest.raises(RuntimeError, match="cudaError"):
            bic_kernel._launch_family(*args, cluster=cluster)
    got = bic_kernel._launch_family(*args, cluster=8)
    torch.cuda.synchronize()
    assert torch.equal(got, bic_kernel.contingency_counts_family_plain(*args))
    shifted = torch.zeros(fam._weights.shape[0] + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        bic_kernel.contingency_counts_family(*args[:4], shifted, *args[5:])


# ---- the score entry: counts reduced to node scores on chip -----------------

SCORE_METRICS = ("bic", "aic", "loglik", "bde")


def _score_case(B, n, U, r_max, q_cap, indegrees, seed=0):
    """The score entry's arguments on the CPU for :func:`_fused_inputs`."""
    codes_u, w, cards, adj = _fused_inputs(B, n, U, r_max, indegrees, seed)
    return (adj, codes_u, w, cards, q_cap, r_max, int(w.sum()))


def _on(device, args):
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in args)


def _scores_close(got, want):
    """Node scores within the float32 tolerance: 1e-5 relative or 1e-3
    absolute (sums of the same terms in another order)."""
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric", SCORE_METRICS)
@pytest.mark.parametrize(
    "B,n,U,r_max,q_cap,indegrees",
    [
        (2, 37, 4973, 2, 256, DECODED_MIX),  # alarm widths: lane-private bins and atomics
        (3, 12, 3000, 4, 64, tuple(range(9))),  # rows past q_cap
        (2, 11, 698, 3, 4096, (0, 2, 5, 8)),  # three states, S = 12,288: one wide tile
        (2, 7, 700, 7, 2341, (0, 2, 6)),  # S = 16,387: 2 tiles of 1,171 configurations
        (2, 6, 900, 3, 5465, (0, 3, 5)),  # S = 16,395: tiles of 8,200 bins would split one
        (2, 6, 1500, 16, 4096, (0, 3, 5)),  # S = 65,536: 4 tiles
        (2, 5, 500, 300, 4, (0, 1, 2)),  # r_max > 255: int32 codes
        (2, 6, 1, 2, 16, (0, 5, 1)),  # U = 1
    ],
    ids=["alarm-widths", "card4", "s12288", "s16387", "s16395-straddle", "s65536",
         "int32-codes", "u1"],
)
def test_score_kernels_equal_plain_on_both_routes(cuda, B, n, U, r_max, q_cap, indegrees,
                                                  metric):
    """The entry on the route route() picks, its narrow kernel where a warp's
    bins fit a block and its wide kernel, each within the float32 tolerance
    of the plain version; every launch of one kernel bit-equal to the
    next."""
    args = (*_score_case(B, n, U, r_max, q_cap, indegrees), metric)
    want, q_want = bic_kernel.node_scores_fused_plain(*args)
    card = _on(cuda, args)
    S = q_cap * r_max
    wide = bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, n)) == "wide"
    before = _score_launch_counts()
    got, q = bic_kernel.node_scores_fused(*card)
    again, _ = bic_kernel.node_scores_fused(*card)
    torch.cuda.synchronize()
    assert _score_launch_counts() == (before[0] + 2 * (not wide), before[1] + 2 * wide)
    assert torch.equal(q.cpu(), q_want) and torch.equal(got, again)
    _scores_close(got, want)

    strides_t, q, codes_cm = bic_kernel._score_inputs(card[0], card[1], card[3], r_max, None)
    kernel_args = (strides_t, q, codes_cm, card[2], card[3], q_cap, r_max, card[6], metric, 1.0)
    by_wide = bic_kernel._launch_scores(*kernel_args, wide=True)
    assert torch.equal(by_wide, bic_kernel._launch_scores(*kernel_args, wide=True))
    assert torch.equal(by_wide, got) or not wide
    _scores_close(by_wide, want)
    if bic_kernel.fused_warp_bytes(S, n) <= bic_kernel.MAX_SHARED_BYTES:
        narrow = bic_kernel._launch_scores(*kernel_args)
        assert torch.equal(narrow, bic_kernel._launch_scores(*kernel_args))
        _scores_close(narrow, want)
        assert torch.equal(narrow, got) or wide


def test_score_entry_through_the_scorer_on_card_equals_cpu(cuda):
    """``BicScorer`` on the card scores through the score entry alone (no
    count launch) at alarm and at barley width (S = 65,536), to the CPU
    scorer's scores; its float64 exact scores still count through the
    fused entry."""
    for name, max_card in (("alarm", 2), ("barley", 16)):
        _, ds = make_synthetic_problem(name, num_cases=800, max_card=max_card)
        n = ds.num_variables
        _, adj = sampler.sample_er_batch(np.random.default_rng(4), 16, n, 2 * n, n,
                                         require_connected=False, max_in_degree=8)
        card = BicScorer(ds, max_parents=8, device=cuda)
        cpu = BicScorer(ds, max_parents=8, device="cpu", impl="plain")
        before, scores_before = _launch_counts(), _score_launch_counts()
        got = card.score(adj)
        torch.cuda.synchronize()
        wide = name == "barley"
        assert _launch_counts() == before
        assert _score_launch_counts() == (scores_before[0] + (not wide), scores_before[1] + wide)
        torch.testing.assert_close(got.cpu(), cpu.score(adj), rtol=1e-5, atol=1e-3)
        _scores_close(card.score_nodes(adj), cpu.score_nodes(adj))
        np.testing.assert_allclose(card.score_exact(adj), cpu.score_exact(adj), rtol=1e-9)


def test_score_wrapper_rejects_what_it_cannot_take(cuda):
    args = _on(cuda, _score_case(2, 6, 64, 2, 16, (1, 2)))
    with pytest.raises(ValueError, match="unknown metric"):
        bic_kernel.node_scores_fused(*args, metric="bdeu")
    with pytest.raises(ValueError, match="on"):
        bic_kernel.node_scores_fused(args[0], args[1], args[2].cpu(), *args[3:])
    strides_t, q, codes_cm = bic_kernel._score_inputs(args[0], args[1], args[3], 2, None)
    kernel_args = (strides_t, q, codes_cm, args[2], args[3], 16, 2, args[6], "bic", 1.0)
    with pytest.raises(RuntimeError, match="cudaError"):  # lane-private bins past a warp
        bic_kernel._launch_scores(*kernel_args, small_span=64)


# ---- the decode's one-query attention --------------------------------------

#: (rows, heads, cache slots N, d_head, positions j run): asia and the
#: default tier (d_head 8), a d_head-4 model, alarm (the island decode's 32,768
#: rows, every position), hepar2 (the large tier, j up to 71), link (726
#: positions, a choice of j that takes every group width of the kernel), and
#: the widths the runner's --embed-size and --num-heads can give beyond the
#: registry's: d_head 32 and 64 (the any-size kernel's 16-byte chunks, at
#: every group width), 12 (chunks past the specialised sizes) and 6 (one
#: float at a time).
ATTENTION_SHAPES = {
    "asia": (4096, 8, 11, 8, range(10)),
    "d_head4": (1024, 4, 11, 4, range(10)),
    "alarm": (32768, 8, 40, 16, range(39)),
    "hepar2": (4096, 8, 73, 16, range(72)),
    "link": (16, 8, 727, 8, (0, 1, 7, 8, 15, 16, 31, 32, 63, 64, 127, 128, 255, 256, 511, 725)),
    "d_head32": (512, 4, 300, 32, (0, 7, 8, 15, 16, 31, 32, 63, 64, 127, 128, 255, 256, 299)),
    "d_head64": (256, 2, 300, 64, (0, 7, 8, 31, 32, 63, 64, 127, 128, 255, 256, 299)),
    "d_head12": (1024, 4, 40, 12, range(39)),
    "d_head6": (1024, 4, 40, 6, range(39)),
}


def _attention_case(device, rows, heads, n, d, layout, seed=0):
    """Keys and values by head in the decode's layout (the self-attention
    buffer [B, H, N, 2, d] or separate [B, H, N, d] tensors), queries, and
    the reach of random DAGs over the N slots in order."""
    g = torch.Generator(device).manual_seed(seed)
    if layout == "self":
        kv = torch.randn((rows, heads, n, 2, d), device=device, generator=g)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    else:
        k, v = (torch.randn((rows, heads, n, d), device=device, generator=g) for _ in range(2))
    q = torch.randn((rows, heads * d), device=device, generator=g)
    adj = torch.triu((torch.rand((rows, n, n), device=device, generator=g) < 2.0 / n).float(),
                     diagonal=1)
    reach = adj.clone()
    for _ in range(max(1, (n - 1).bit_length())):
        reach = torch.clamp(reach + reach @ reach, 0.0, 1.0)
    return q, k, v, reach


def _pair_disagreement(got, want, heads) -> float:
    """The share of (row, head) pairs whose outputs part by more than 1e-6
    of the largest output."""
    diff = (got - want).abs().view(got.shape[0], heads, -1).amax(-1)
    return float((diff > 1e-6 * want.abs().max()).float().mean())


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"], ids=["float32", "bf16"])
@pytest.mark.parametrize("layout", ["self", "cross"])
@pytest.mark.parametrize("shape", sorted(ATTENTION_SHAPES))
def test_decode_attention_kernel_equals_plain(cuda, shape, layout, matmul_dtype):
    """float32: to 1e-6 of the largest output.  bfloat16 weights: to 2^-7
    of the largest value (a weight one float32 ulp from the plain one may
    round to the next bfloat16 value), and at most 1% of the (row, head)
    pairs past 1e-6, where the weights left unrounded part from the plain
    version in most pairs that attend more than one key (checked on the
    same inputs: the test tells a kernel that skips the rounding)."""
    rows, heads, n, d, positions = ATTENTION_SHAPES[shape]
    q, k, v, reach = _attention_case(cuda, rows, heads, n, d, layout)
    tol = 1e-6 if matmul_dtype is None else 2.0**-7
    moved, parted = [], []
    for j in positions:
        args = (q, k[:, :, :j + 1], v[:, :, :j + 1], reach[:, :j + 1, j], matmul_dtype)
        before = decode_attention.decode_attention.launches
        got = decode_attention.decode_attention(*args)
        want = decode_attention.decode_attention_plain(*args)
        torch.cuda.synchronize()
        assert decode_attention.decode_attention.launches == before + 1
        scale = want.abs().max() if matmul_dtype is None else v[:, :, :j + 1].abs().max()
        err = float((got - want).abs().max() / scale)
        assert err <= tol, (j, err)
        if matmul_dtype is not None:
            unrounded = decode_attention.decode_attention_plain(*args[:4], None)
            moved.append(_pair_disagreement(unrounded, want, heads))
            parted.append(_pair_disagreement(got, want, heads))
    if matmul_dtype is not None:
        assert max(moved) >= 0.1, moved
        assert max(parted) <= 0.01, parted


def test_decode_attention_kernel_takes_misaligned_views(cuda):
    """Rows off 16-byte boundaries (d = 8 views one float into a wider
    buffer) take the kernel's one-float loads, and equal the plain version
    as the aligned layout does."""
    q, k, v, reach = _attention_case(cuda, 256, 4, 40, 9, "self")
    q = q.view(256, 4, 9)[..., 1:].reshape(256, 32)
    for j in (0, 5, 20, 39):
        args = (q, k[:, :, :j + 1, 1:], v[:, :, :j + 1, 1:], reach[:, :j + 1, j])
        got = decode_attention.decode_attention(*args)
        want = decode_attention.decode_attention_plain(*args)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6, j


def test_decode_attention_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    q, k, v, reach = _attention_case(cuda, 4, 2, 8, 8, "cross")
    mask = reach[:, :, 7]
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention.decode_attention(q.t().contiguous().t(), k, v, mask)
    with pytest.raises(ValueError, match="contiguous floats"):
        decode_attention.decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3)
                                          [:, :, :, :8], v, mask)
    with pytest.raises(ValueError, match="rounding"):
        decode_attention.decode_attention(q, k, v, mask, "int8")
    long = torch.zeros((1, 1, decode_attention.MAX_LENGTH + 1, 8), device=cuda)
    with pytest.raises(ValueError, match="L="):
        decode_attention.decode_attention(torch.zeros((1, 8), device=cuda), long, long,
                                          torch.zeros((1, long.shape[2]), device=cuda))


def test_alarm_decode_attends_through_the_kernel(cuda):
    """One decode at alarm's widths (d_head 16, N = 40): 2 calls a layer (self
    and cross) x 4 layers x 39 positions, all through the kernel, and no
    library attention (``aten::baddbmm``) on the path."""
    from torch.profiler import ProfilerActivity, profile

    model = pace_vae.make_model(0, cuda, num_real_vertices=37, real_label_cardinality=37,
                                embed_size=64, num_layers=4, latent_size=896, fc_hidden=64,
                                edge_readout=True)
    z = torch.randn(256, 896, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = decode_attention.decode_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode.decode_to_labeled(model, z, torch.Generator(cuda).manual_seed(1), max_in_degree=8)
        torch.cuda.synchronize()
    assert decode_attention.decode_attention.launches - before == 2 * 4 * 39
    assert "aten::baddbmm" not in {e.name for e in prof.events()}


# The decode's CUDA graphs (``models/decode.py``): a decode through
# ``sample_decode`` replays the graphs its workspace captured in its first
# call; a workspace made apart and run by hand has no graphs and calls the
# same slot functions directly.  Replays must give the direct calls' bits.
GRAPH_WIDTHS = {
    "alarm": dict(num_real_vertices=37, real_label_cardinality=37, embed_size=64, num_layers=4,
                  latent_size=896, fc_hidden=64, edge_readout=True),
    "hepar2": dict(num_real_vertices=70, real_label_cardinality=70, embed_size=64,
                   num_layers=4, latent_size=1792, fc_hidden=64, edge_readout=True,
                   edge_readout_rank=64),
}


@pytest.fixture(scope="module")
def graph_models():
    """The model at each width of ``GRAPH_WIDTHS``, made at first use."""
    models = {}

    def get(name):
        if name not in models:
            models[name] = pace_vae.make_model(0, "cuda", **GRAPH_WIDTHS[name]).eval()
        return models[name]

    return get


def _direct_decode(model, z, generator, temperature, max_in_degree):
    ws = decode.DecodeWorkspace(model, z.shape[0], z.device, True, temperature, max_in_degree)
    ws.load(z, temperature)
    with torch.no_grad():
        return ws.run(model, generator)


def _graphed_and_direct(model, z, seed, temperature=1.0, max_in_degree=8):
    """(the graphed decode, the direct one, their generators afterwards)."""
    gens = [torch.Generator(z.device).manual_seed(seed) for _ in range(2)]
    got = decode.sample_decode(model, z, gens[0], temperature=temperature,
                               max_in_degree=max_in_degree)
    want = _direct_decode(model, z, gens[1], temperature, max_in_degree)
    return got, want, gens


def _counts_of(fn):
    """The program's counters over ``fn()`` (a profiler session turns them
    on), with the decode-attention kernels the card ran, from the session's
    device trace, under ``"attention_kernels"``."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from dags_vae_search_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = dict(profiling.snapshot()["counts"])
    kernel = re.compile(r"\bdecode_attention(_any)?_kernel\b")
    counts["attention_kernels"] = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel.search(e.name))
    return out, counts


@pytest.mark.parametrize("max_in_degree", [8, None])
@pytest.mark.parametrize("temperature", [1.0, 0.25, 0.1, 1e-4])
@pytest.mark.parametrize("rows", [256, 4096])
@pytest.mark.parametrize("widths", sorted(GRAPH_WIDTHS))
def test_graphed_decode_equals_direct_calls(cuda, graph_models, widths, rows, temperature,
                                            max_in_degree):
    """Three calls in a row, other latents and generators (the first calls
    the slot functions directly and captures, the others replay): labels,
    adjacency and finished bit-equal to the slot functions called directly,
    and the generators left alike."""
    model = graph_models(widths)
    for call in range(3):
        z = torch.randn(rows, model.latent_size, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(10 + call))
        got, want, gens = _graphed_and_direct(model, z, 20 + call, temperature, max_in_degree)
        for name, g, w in zip(("labels", "adj", "finished"), got, want):
            assert torch.equal(g, w), (call, name)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    key = decode.workspace_key(model, z, True, temperature, max_in_degree)
    assert decode._workspaces[model][key].graphs is not None


def test_a_second_call_replays_without_capturing_and_counts_its_launches(cuda):
    """The first call decodes directly (its wrapper counts each launch) and
    captures (no launch); the second replays: the card runs the kernel
    2 x 4 x 39 times (its device trace), and the wrapper counts nothing."""
    model = pace_vae.make_model(2, cuda, **GRAPH_WIDTHS["alarm"]).eval()
    z = torch.randn(256, model.latent_size, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    gen = torch.Generator(cuda).manual_seed(1)
    launches = decode_attention.decode_attention
    for call, (captures, graph_rows, wrapper) in enumerate([(1, 0, 2 * 4 * 39), (0, 256, 0)]):
        before = launches.launches
        _, counts = _counts_of(lambda: decode.sample_decode(model, z, gen, max_in_degree=8))
        assert launches.launches - before == wrapper, call
        assert counts["attention_kernels"] == 2 * 4 * 39, call
        assert counts.get("decode.graph_captures", 0) == captures, call
        assert counts["decode.graph_rows"] == graph_rows and counts["decode.rows"] == 256, call


def test_replays_read_weights_changed_in_place_and_a_replaced_one_recaptures(cuda):
    """A weight changed in place is what the next replay reads; a parameter
    replaced by another tensor moves the decode to a new capture, which
    reads the new one."""
    model = pace_vae.make_model(1, cuda, **GRAPH_WIDTHS["alarm"]).eval()
    z = torch.randn(256, model.latent_size, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    first, _, _ = _graphed_and_direct(model, z, 5)
    g = torch.Generator(cuda).manual_seed(6)
    with torch.no_grad():
        model.add_node_out.bias.add_(4.0 * torch.randn(model.add_node_out.bias.shape,
                                                       device=cuda, generator=g))
    (got, want, _), counts = _counts_of(lambda: _graphed_and_direct(model, z, 5))
    assert counts.get("decode.graph_captures", 0) == 0 and counts["decode.graph_rows"] == 256
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[0], first[0])

    bias = model.add_node_out.bias.detach()
    model.add_node_out.bias = torch.nn.Parameter(
        bias + 4.0 * torch.randn(bias.shape, device=cuda, generator=g))
    (again, want, _), counts = _counts_of(lambda: _graphed_and_direct(model, z, 5))
    assert counts["decode.graph_captures"] == 1 and counts["decode.graph_rows"] == 0
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    assert not torch.equal(again[0], got[0])


@pytest.mark.parametrize("temperature", [1.0, 0.25, 0.1, 1e-4])
def test_inv_t_as_a_card_tensor_has_the_python_scalar_s_bits(cuda, temperature):
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(1 << 16, device=cuda, generator=g) * 100.0
    ws = decode.DecodeWorkspace(pace_vae.make_model(0, cuda, **GRAPH_WIDTHS["alarm"]), 1, cuda,
                                True, temperature, None)
    ws.load(torch.zeros(1, 896, device=cuda), temperature)
    assert torch.equal(x * ws.inv_t, x * (1.0 / max(temperature, 1e-3)))


def test_a_model_keeps_its_last_workspaces_and_frees_them_with_it(cuda):
    """Decodes at six batch sizes keep the model's ``MAX_WORKSPACES`` used
    last (one used again stays, not captured anew); dropping the model frees
    its workspaces: their tensors go, and the memory they held but a
    remainder (the libraries keep a workspace for each stream a capture
    used) is free again."""
    import gc
    import weakref

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = pace_vae.make_model(3, cuda, **GRAPH_WIDTHS["alarm"]).eval()
    with_model = torch.cuda.memory_allocated()
    gen = torch.Generator(cuda).manual_seed(0)

    def decode_rows(rows):
        z = torch.randn(rows, model.latent_size, device=cuda, generator=gen)
        return _counts_of(lambda: decode.sample_decode(model, z, gen, max_in_degree=8))[1]

    for rows in (1024, 1536, 2048, 2560, 3072, 3584):
        assert decode_rows(rows)["decode.graph_captures"] == 1
    assert [key[0] for key in decode._workspaces[model]] == [2048, 2560, 3072, 3584]
    counts = decode_rows(2048)
    assert counts.get("decode.graph_captures", 0) == 0 and counts["decode.graph_rows"] == 2048
    assert decode_rows(4096)["decode.graph_captures"] == 1
    assert [key[0] for key in decode._workspaces[model]] == [3072, 3584, 2048, 4096]
    kept = [weakref.ref(ws.labels) for ws in decode._workspaces[model].values()]
    held = torch.cuda.memory_allocated() - with_model
    assert held > 2**29
    del model
    gc.collect()
    torch.cuda.synchronize()
    assert all(ref() is None for ref in kept)
    assert torch.cuda.memory_allocated() - base < held / 4
