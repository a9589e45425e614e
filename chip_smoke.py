#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dags_vae_search_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX.  Phases, in
order; any failure exits non-zero:

1. device  — the card's name and power limit;
2. kernels — builds ``csrc/contingency_counts.cu`` and runs both of its
   entries at the alarm search shape (2048 candidates x 37 nodes x 4,973
   unique rows x 512 cells) on sampled ER candidates: the seg entry against
   its plain torch version, the fused entry against its plain version and
   against the seg entry (all bit-equal); times each entry, its plain
   version, the ``torch.bincount`` yardstick and the unfused path the fused
   entry replaces (``cell_index`` + seg entry) with CUDA events;
3. card vs CPU — counts (exact) and scores (f32 tolerance, float64 exact
   path to 1e-9) of 64 candidates against the CPU plain scorer, and the
   alarm-width model's loss on a small batch against the CPU;
3b. train step, card vs CPU — a small model (dropout and noise off) from
   one seed takes 3 optimizer steps on the same batches on both devices,
   the clip active on the first; losses and parameters to rtol 1e-4;
4. search  — the alarm-width CEM latent search (registry width, seeded
   random weights) for 3 iterations of 2048 candidates, with each
   iteration's wall time and the kernels' launch counts read from that run
   alone; then one more decoded population, timed by phase, on which both
   entries are checked and timed again;
5. training — the alarm registry experiment (16,260,634 parameters, its
   ``TrainConfig`` as the registry gives it) on a corpus from
   ``generate_corpus`` with one cut (corpus batch 8 instead of 64), split
   0.9 / 0.1: 2 epochs on the chunked loop, then 20 steps of the per-step
   loop from the same state; step ms, graphs/s, host ms per step, peak
   memory and losses per path and epoch;
6. checkpoint and eval — ``save_checkpoint`` / ``restore_params`` round
   trip (bit-equal), ``evaluate_corpus`` on 4 test batches;
7. search with the trained model — one CEM iteration of 2048 candidates
   through the kernel scorer, its launch counts read from that run alone;
8. where a train step's time goes — the two loops in turns on the same 20
   steps (chunked, per-step, per-step, chunked), then a ``torch.profiler``
   window over a few chunked steps: device time and kernel launches per
   step, the device's busy share of the unprofiled step, the top kernels
   and host operations.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it holds the kernels' JSON record, and a ``train:`` line holds phases 5-7.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
CEM_ITERS = 3
#: the one cut of the alarm corpus: graphs per curriculum batch (registry: 64)
CORPUS_BATCH = 8
TRAIN_EPOCHS = 2
PER_STEP_STEPS = 20
EVAL_BATCHES = 4
PROFILE_STEPS = 5
#: the train-step check's model: the parity tests' small width, deterministic
SMALL_TRAIN = dict(num_real_vertices=5, real_label_cardinality=5, embed_size=16, num_heads=4,
                   num_layers=2, latent_size=16, fc_hidden=16, dropout=0.0, epsilon_scale=0.0,
                   edge_readout=True)
KERNELS = ("contingency_counts_fused", "contingency_counts")
#: Published H100 SXM peak HBM bytes/s.
H100_BYTES_PER_S = 3.35e12
#: INT32 lanes of one H100 SXM per clock: 132 SMs x 64.
H100_INT32_LANES = 132 * 64
SOURCE = "dags_vae_search_tpu_torch/csrc/contingency_counts.cu"
REPLACES = "dags_vae_search_tpu/ops/bic_pallas.py:46"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> tuple:
    """The card's name, and its largest SM clock in Hz (for the integer bound)."""
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(nvidia_smi("name,power.limit"))
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    print(f"max SM clock {clock_hz / 1e6:.0f} MHz")
    return name, clock_hz


def describe_rows(torch, adj, label: str) -> None:
    """In-degree histogram of the rows, and the share that takes the fused
    kernel's lane-private bins (binary data: span 2^(k+1) cells)."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    indeg = adj.sum(dim=1).reshape(-1).to(torch.int64)
    hist = torch.bincount(indeg, minlength=9).tolist()
    private = float((2 ** (indeg + 1) <= bic_kernel.SMALL_SPAN).float().mean())
    print(f"{label}: in-degree histogram {hist}, mean {float(indeg.float().mean()):.3f}, "
          f"rows on lane-private bins {private:.3f}")


def time_entries(torch, scorer, adj, label: str, clock_hz: float) -> dict:
    """Check both entries on the candidates ``adj`` (bit-equal to their plain
    versions and to each other) and time them, their plain versions, the
    yardstick and the unfused path; bounds from these inputs."""
    from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch

    pop, n, _ = adj.shape
    w, q_cap, r_max = scorer._weights, scorer.q_cap, scorer.r_max
    S = q_cap * r_max
    U = w.shape[0]
    R = pop * n
    strides, _ = bic_torch.parent_config_strides(adj, scorer._cards)
    strides_t = strides.transpose(1, 2).contiguous()
    codes_cm = scorer._codes_cm
    describe_rows(torch, adj, label)

    def unfused():
        seg = bic_torch.cell_index(scorer._codes_u, strides, q_cap, r_max)
        return bic_kernel.contingency_counts_kernel(w, seg.reshape(R, U), S)

    def fused():
        return bic_kernel.contingency_counts_fused(strides_t, codes_cm, w, q_cap, r_max)

    seg = bic_torch.cell_index(scorer._codes_u, strides, q_cap, r_max).reshape(R, U)
    out_seg = bic_kernel.contingency_counts_kernel(w, seg, S)
    out_fused = fused()
    torch.cuda.synchronize()
    # integer counts below 2^24 are exact in f32 in any order: tolerance 0
    want_seg = bic_kernel.contingency_counts_plain(w, seg, S)
    check(torch.equal(out_seg, want_seg), f"{label}: seg kernel differs from its plain version")
    want_fused = bic_kernel.contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    check(torch.equal(out_fused, want_fused), f"{label}: fused kernel differs from its plain version")
    check(torch.equal(out_fused, out_seg), f"{label}: fused counts differ from seg-kernel counts")
    err_seg = float((out_seg - want_seg).abs().max())
    err_fused = float((out_fused - want_fused).abs().max())
    total = float(out_fused.sum(dtype=torch.float64))
    check(total == float(w.sum(dtype=torch.float64)) * R, f"{label}: counts do not sum to the cases")
    print(f"{label}: seg kernel vs plain max |diff| {err_seg}, fused kernel vs plain max |diff| "
          f"{err_fused}, fused vs seg equal (tolerance 0, bit-equal)")
    del out_seg, out_fused, want_seg, want_fused

    flat = (torch.arange(R, device="cuda", dtype=torch.int64)[:, None] * S + seg).reshape(-1)
    w_rep = w.expand(R, U).reshape(-1)
    t = {
        "fused_ms": cuda_ms(fused, reps=20),
        "seg_ms": cuda_ms(lambda: bic_kernel.contingency_counts_kernel(w, seg, S), reps=20),
        "before_ms": cuda_ms(unfused, reps=10),
        "fused_plain_ms": cuda_ms(
            lambda: bic_kernel.contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max),
            reps=3, warmup=1),
        "seg_plain_ms": cuda_ms(lambda: bic_kernel.contingency_counts_plain(w, seg, S), reps=3, warmup=1),
        "bincount_ms": cuda_ms(
            lambda: torch.bincount(flat, weights=w_rep, minlength=R * S), reps=3, warmup=1),
        "small_span_ms": {
            span: cuda_ms(lambda: bic_kernel._launch_fused(strides_t, codes_cm, w, q_cap, r_max, span),
                          reps=10)
            for span in (0, 8, 16, 32, 64)
        },
        "err_seg": err_seg,
        "err_fused": err_fused,
    }
    del flat, w_rep, seg
    int_rate = H100_INT32_LANES * clock_hz
    parents = float(adj.sum())
    fused_bytes = strides_t.numel() * 4 + codes_cm.numel() * codes_cm.element_size() + U * 4 + R * S * 4
    fused_ops = U * (parents + 2 * R)  # per row and unique row: parents' multiply-adds, child, bin
    seg_bytes = R * U * 4 + U * 4 + R * S * 4
    seg_ops = R * U  # one bin add per cell
    for key, nbytes, ops in (("fused", fused_bytes, fused_ops), ("seg", seg_bytes, seg_ops)):
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = ops / int_rate * 1e3
        t[f"{key}_bytes"], t[f"{key}_int_ops"] = nbytes, ops
        t[f"{key}_bound_ms"] = max(bytes_ms, ops_ms)
        t[f"{key}_bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"{label}: " + json.dumps(t))
    return t


def phase_kernels(torch, cfg, scorer, clock_hz) -> dict:
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.ops import _build

    n, pop = cfg.num_vertices, cfg.search.cem_population
    rng = np.random.default_rng(SEED)
    # 2n edges, as the TPU bench sampled candidates; in-degree capped like decodes
    _, adj_np = sampler.sample_er_batch(
        rng, pop, n, 2 * n, n, max_in_degree=cfg.search.max_parents
    )
    print(f"kernel shape: R={pop * n} (B={pop} x n={n}) U={scorer.num_unique_rows} "
          f"S={scorer.q_cap * scorer.r_max}")

    t0 = time.perf_counter()
    _build.load("contingency_counts")
    print(f"contingency_counts build+load {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("contingency_counts", "").splitlines():
        if "entry function" in line or "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return time_entries(torch, scorer, torch.as_tensor(adj_np, device="cuda"), "ER candidates",
                        clock_hz)


def phase_card_vs_cpu(torch, cfg, scorer, dataset) -> None:
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.models.pace_vae import make_model
    from dags_vae_search_tpu_torch.scoring.bic import BicScorer

    n = cfg.num_vertices
    rng = np.random.default_rng(SEED + 1)
    _, adj = sampler.sample_er_batch(rng, 64, n, 2 * n, n, max_in_degree=cfg.search.max_parents)
    cpu = BicScorer(dataset, max_parents=cfg.search.max_parents, device="cpu", impl="plain")
    counts_gpu, q_gpu = scorer.counts(adj)
    counts_cpu, q_cpu = cpu.counts(adj)
    check(torch.equal(counts_gpu.cpu(), counts_cpu), "card counts differ from CPU counts")
    check(torch.equal(q_gpu.cpu(), q_cpu), "card q differs from CPU q")
    s_gpu = scorer.score(adj).cpu()
    s_cpu = cpu.score(adj)
    # f32 sums of ~37 x 512 cells in another order: 1e-5 relative
    check(bool(torch.all(torch.isfinite(s_gpu))), "non-finite card scores")
    check(torch.allclose(s_gpu, s_cpu, rtol=1e-5, atol=0.0), "card scores differ from CPU")
    e_gpu, e_cpu = scorer.score_exact(adj), cpu.score_exact(adj)
    check(np.allclose(e_gpu, e_cpu, rtol=1e-9, atol=0.0), "score_exact differs from CPU")
    print(
        f"card vs CPU: 64 candidates, counts equal, max |score diff| "
        f"{float((s_gpu - s_cpu).abs().max()):.6g} (rtol 1e-5), "
        f"max |exact diff| {float(np.abs(e_gpu - e_cpu).max()):.3g} (rtol 1e-9)"
    )

    # the alarm-width model's deterministic loss on 4 graphs, card vs CPU
    model_gpu = make_model(SEED, "cuda", **cfg.model_kwargs()).eval()
    model_cpu = make_model(SEED, "cpu", **cfg.model_kwargs()).eval()
    labels, adj4 = sampler.sample_er_batch(rng, 4, n, 2 * n, n, max_in_degree=cfg.search.max_parents)
    labels_t, adj_t = torch.as_tensor(labels), torch.as_tensor(adj4)
    with torch.no_grad():
        loss_gpu = torch.stack(model_gpu.loss(labels_t.cuda(), adj_t.cuda())).cpu()
        loss_cpu = torch.stack(model_cpu.loss(labels_t, adj_t))
    check(torch.allclose(loss_gpu, loss_cpu, rtol=1e-4, atol=1e-3), f"model loss {loss_gpu} vs {loss_cpu}")
    print(f"model loss card {loss_gpu.tolist()} vs CPU {loss_cpu.tolist()} (rtol 1e-4)")


def phase_train_card_vs_cpu(torch) -> None:
    """3 optimizer steps of a small model on both devices, the clip active on
    the first; losses and parameters held to rtol 1e-4 / atol 1e-5."""
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.models.pace_vae import make_model
    from dags_vae_search_tpu_torch.training.train import TrainConfig, Trainer

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    labels, adj = sampler.sample_er_batch(np.random.default_rng(SEED + 2), 48, 5, 6, 5)
    runs = []
    for dev in ("cpu", "cuda"):
        trainer = Trainer(make_model(SEED, dev, **SMALL_TRAIN), TrainConfig(batch_size=16,
                                                                            learning_rate=1e-3))
        state = trainer.init_state(SEED)
        losses, norms = [], []
        for i, clip_norm in enumerate((1.0, 1e9, 1e9)):
            trainer.config.clip_norm = clip_norm
            lb = torch.as_tensor(labels[16 * i:16 * (i + 1)], device=dev)
            ad = torch.as_tensor(adj[16 * i:16 * (i + 1)], device=dev)
            losses.append(trainer.compute_gradients(state, lb, ad).cpu())
            grads = [p.grad for p in state.model.parameters()]
            norms.append(float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))))
            state = trainer.apply_gradients(state)
        runs.append((torch.stack(losses), norms, state.model.state_dict()))
    (l_cpu, n_cpu, p_cpu), (l_card, n_card, p_card) = runs
    check(n_cpu[0] > 1.0, f"the clip was not active on the first step (norm {n_cpu[0]})")
    check(torch.allclose(l_card, l_cpu, rtol=1e-4, atol=1e-5), f"train losses {l_card} vs {l_cpu}")
    # attention key biases have a zero gradient in exact arithmetic: Adam
    # turns its rounding noise into +-lr steps that move no output
    worst = 0.0
    for name, value in p_cpu.items():
        if name.endswith("k_proj.bias"):
            continue
        got = p_card[name].cpu()
        check(torch.allclose(got, value, rtol=1e-4, atol=1e-5), f"train step parameter {name}")
        worst = max(worst, float((got - value).abs().max()))
    print(f"train step card vs CPU: 3 steps, grad norms card {n_card} / CPU {n_cpu} "
          f"(clip 1.0 on step 1), max |loss diff| {float((l_card - l_cpu).abs().max()):.3g}, "
          f"max |param diff| {worst:.3g} (rtol 1e-4, atol 1e-5)")


def reset_launches() -> None:
    from dags_vae_search_tpu_torch.ops import bic_kernel

    bic_kernel.contingency_counts_fused.launches = 0
    bic_kernel.contingency_counts_kernel.launches = 0


def read_launches() -> dict:
    from dags_vae_search_tpu_torch.ops import bic_kernel

    return {
        "contingency_counts_fused": bic_kernel.contingency_counts_fused.launches,
        "contingency_counts": bic_kernel.contingency_counts_kernel.launches,
    }


def check_best_exact(torch, scorer, result, n: int) -> float:
    """The best graph re-scored exactly from its labels, in float64 on the
    card; it must equal the f32 best to 1e-5 relative."""
    from dags_vae_search_tpu_torch.search.latent import _relabel_and_check

    check(np.isfinite(result.best_score), f"best BIC {result.best_score} is not finite")
    check(sorted(result.best_labels.tolist()) == list(range(n)), "best labels are not a permutation")
    best_cols = _relabel_and_check(
        torch.as_tensor(result.best_labels[None], device="cuda"),
        torch.as_tensor(result.best_adj[None], device="cuda"),
    )[0]
    exact = float(scorer.score_exact(best_cols)[0])
    check(abs(exact - result.best_score) <= 1e-5 * abs(exact), f"best {result.best_score} vs exact {exact}")
    return exact


def phase_search(torch, cfg, scorer, clock_hz) -> tuple:
    from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
    from dags_vae_search_tpu_torch.models.pace_vae import make_model, num_parameters
    from dags_vae_search_tpu_torch.search.latent import _relabel_and_check, cem_search

    model = make_model(SEED, "cuda", **cfg.model_kwargs())
    params = num_parameters(model)
    check(params == 16_260_634, f"alarm model has {params} parameters, want 16,260,634")
    pop = cfg.search.cem_population

    # each iteration ends in one score call: stamp its end (after a sync that
    # the iteration's argmax would make anyway) to get per-iteration times
    stamps = []
    score = scorer.score

    def stamped_score(adj):
        out = score(adj)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    scorer.score = stamped_score
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = cem_search(model, scorer, seed=SEED, iters=CEM_ITERS, population=pop, device="cuda")
        torch.cuda.synchronize()
    finally:
        del scorer.score
    search_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    iter_s = np.diff([t0, *stamps]).tolist()
    for i, dt in enumerate(iter_s):
        print(f"CEM iteration {i}: {dt:.4f} s (to the end of its score call)")

    check(len(stamps) == CEM_ITERS, f"{len(stamps)} score calls in {CEM_ITERS} iterations")
    check(launches["contingency_counts_fused"] == CEM_ITERS,
          f"fused kernel launched {launches['contingency_counts_fused']} times in {CEM_ITERS} iterations")
    check(result.num_evals == CEM_ITERS * pop, "evaluation count")
    check(all(b >= a for a, b in zip(result.history, result.history[1:])), "history decreased")
    exact = check_best_exact(torch, scorer, result, cfg.num_vertices)

    # one more population, timed by phase
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    z = torch.randn((pop, model.latent_size), generator=gen, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon, valid = decode_to_labeled(
        model, z, gen, max_in_degree=scorer.max_parents
    )
    relabeled, is_perm = _relabel_and_check(recon.labels, recon.adj)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scores = scorer.score(relabeled)
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t0) * 1e3
    valid_frac = float((valid & is_perm).float().mean())
    finite_frac = float(torch.isfinite(scores).float().mean())
    decoded = time_entries(torch, scorer, relabeled, "decoded candidates", clock_hz)
    search = {
        "params": params,
        "population": pop,
        "iters": CEM_ITERS,
        "evals": result.num_evals,
        "best_bic": result.best_score,
        "best_bic_exact": exact,
        "history": result.history,
        "search_s": search_s,
        "iter_s": iter_s,
        "candidates_per_s": result.num_evals / search_s,
        "candidates_per_s_after_first": (CEM_ITERS - 1) * pop / (stamps[-1] - stamps[0]),
        "decode_ms_per_iter": decode_ms,
        "score_ms_per_iter": score_ms,
        "valid_decode_fraction": valid_frac,
        "finite_score_fraction": finite_frac,
        "peak_mem_gib": peak_gib,
        "kernel_launches": launches,
    }
    return search, decoded


def phase_train(torch, cfg) -> tuple:
    """Phase 5: the alarm experiment's training on both loops."""
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE, num_parameters
    from dags_vae_search_tpu_torch.training import data
    from dags_vae_search_tpu_torch.training.train import Trainer

    c = cfg.corpus
    t0 = time.perf_counter()
    labels, adj = sampler.generate_corpus(
        np.random.default_rng(cfg.seed), cfg.num_vertices, cfg.label_cardinality, CORPUS_BATCH,
        c.steps_limit, c.density_limit, c.label_method, max_in_degree=c.max_in_degree,
    )
    gen_s = time.perf_counter() - t0
    train_c, test_c = data.train_test_split(data.Corpus(labels, adj), c.test_ratio, cfg.seed)
    print(f"alarm corpus: {len(labels)} graphs generated on the host in {gen_s:.2f} s "
          f"(corpus batch {CORPUS_BATCH}); split {len(train_c)} train / {len(test_c)} test")

    trainer = Trainer(PaceVAE(**cfg.model_kwargs()).to("cuda"), cfg.train)
    state = trainer.init_state(cfg.seed)
    params = num_parameters(state.model)
    check(params == 16_260_634, f"alarm model has {params} parameters, want 16,260,634")
    b = cfg.train.batch_size

    def log(line):
        print("  fit:", line)

    def run(fit_trainer, st, corpus, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_run = time.perf_counter()
        st, hist = fit_trainer.fit(st, corpus, log=log, **kwargs)
        torch.cuda.synchronize()
        return st, hist, {"seconds": time.perf_counter() - t_run, "launches": read_launches(),
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

    state, chunked, chunked_run = run(trainer, state, train_c, epochs=TRAIN_EPOCHS)
    # the per-step loop from the same state, on the first PER_STEP_STEPS batches' rows
    per_step_trainer = Trainer(state.model, dataclasses.replace(cfg.train, steps_per_call=1))
    cut = train_c.take(np.arange(PER_STEP_STEPS * b))
    state, per_step, per_step_run = run(per_step_trainer, state, cut, epochs=1,
                                        start_epoch=TRAIN_EPOCHS + 1)

    keys = ("loss_per_graph", "recon_per_graph", "kld_per_graph")
    for h in chunked + per_step:
        check(all(np.isfinite(h[k]) for k in keys), f"non-finite training loss {h}")
    check(chunked[1]["loss_per_graph"] < chunked[0]["loss_per_graph"],
          f"epoch 2 loss {chunked[1]['loss_per_graph']} not below epoch 1's "
          f"{chunked[0]['loss_per_graph']}")
    check(state.step == TRAIN_EPOCHS * (len(train_c) // b) + PER_STEP_STEPS,
          f"{state.step} optimizer steps")
    check(chunked_run["launches"] == per_step_run["launches"] == dict.fromkeys(KERNELS, 0),
          "a kernel launched in training")
    for name, hist, run_info in (("chunked", chunked, chunked_run),
                                 ("per-step", per_step, per_step_run)):
        for h in hist:
            print(f"train {name} epoch {h['epoch']}: step {h['step_ms']:.3f} ms, "
                  f"{h['graphs_per_second']:,.1f} graphs/s, host {h['dispatch_ms']:.3f} ms/step, "
                  f"peak {run_info['peak_mem_gib']:.3f} GiB, loss/recon/KL per graph "
                  f"{h['loss_per_graph']:.4f} / {h['recon_per_graph']:.4f} / "
                  f"{h['kld_per_graph']:.4f}, lr {h['lr']:.2e}")
    record = {
        "params": params,
        "corpus_graphs": len(labels),
        "corpus_gen_s": gen_s,
        "train_rows": len(train_c),
        "test_rows": len(test_c),
        "steps_per_epoch": len(train_c) // b,
        "chunked": {"history": chunked, **chunked_run},
        "per_step": {"history": per_step, **per_step_run},
        "chunked_speedup": per_step[0]["step_ms"] / chunked[-1]["step_ms"],
    }
    return trainer, state, train_c, test_c, record


def phase_checkpoint_eval(torch, cfg, model, test_c) -> dict:
    """Phase 6: checkpoint round trip, then reconstruction eval."""
    from dags_vae_search_tpu_torch.training import checkpoint
    from dags_vae_search_tpu_torch.training.eval import evaluate_corpus

    want = {k: v.clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(tmp, TRAIN_EPOCHS, {"params": model.state_dict()})
        check(checkpoint.latest_epoch(tmp) == TRAIN_EPOCHS, "latest checkpoint epoch")
        restored = checkpoint.restore_params(
            tmp, TRAIN_EPOCHS, {k: torch.zeros_like(v) for k, v in want.items()}
        )
        ckpt_s = time.perf_counter() - t0
    check(set(restored) == set(want) and all(torch.equal(restored[k], v) for k, v in want.items()),
          "restored checkpoint differs")
    model.load_state_dict(restored)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = evaluate_corpus(model, test_c, cfg.train.batch_size, seed=cfg.seed + 1,
                              max_batches=EVAL_BATCHES, use_isomorphism=False)
    eval_s = time.perf_counter() - t0
    check(metrics["valid_ratio_mode"] == 1.0, f"valid_ratio_mode {metrics['valid_ratio_mode']}")
    print(f"checkpoint: save + restore {ckpt_s:.2f} s, bit-equal; eval of {EVAL_BATCHES} x "
          f"{cfg.train.batch_size} test graphs {eval_s:.2f} s: valid_ratio_mode "
          f"{metrics['valid_ratio_mode']}, structure_accuracy_mode "
          f"{metrics['structure_accuracy_mode']}")
    return {"checkpoint_s": ckpt_s, "eval_s": eval_s, **metrics}


def phase_train_search(torch, cfg, scorer, model) -> dict:
    """Phase 7: one CEM iteration with the trained model."""
    from dags_vae_search_tpu_torch.search.latent import cem_search

    pop = cfg.search.cem_population
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = cem_search(model, scorer, seed=SEED, iters=1, population=pop, device="cuda")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["contingency_counts_fused"] == 1,
          f"fused kernel launched {launches['contingency_counts_fused']} times in one iteration")
    exact = check_best_exact(torch, scorer, result, cfg.num_vertices)
    print(f"trained-model CEM iteration: {pop} candidates in {search_s:.3f} s, best BIC "
          f"{result.best_score:.2f} (float64 {exact:.4f}), launches {launches}")
    return {"best_bic": result.best_score, "best_bic_exact": exact, "search_s": search_s,
            "candidates_per_s": pop / search_s, "kernel_launches": launches}


def phase_step_time(torch, cfg, trainer, state, train_c) -> dict:
    """Phase 8: the two loops timed in turns on the same 20-step cut
    (chunked, per-step, per-step, chunked), then device time and kernel
    launches of PROFILE_STEPS chunked steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from dags_vae_search_tpu_torch.training.train import Trainer

    b = cfg.train.batch_size
    cut = train_c.take(np.arange(PER_STEP_STEPS * b))
    per_step_trainer = Trainer(state.model, dataclasses.replace(cfg.train, steps_per_call=1))
    turns = {"chunked": [], "per_step": []}
    for name in ("chunked", "per_step", "per_step", "chunked"):
        fit_trainer = trainer if name == "chunked" else per_step_trainer
        state, hist = fit_trainer.fit(state, cut, epochs=1, log=lambda line: None)
        turns[name].append(hist[0]["step_ms"])
    step_ms = float(np.mean(turns["chunked"]))
    record = {"turns_step_ms": turns,
              "chunked_speedup": float(np.mean(turns["per_step"])) / step_ms}
    print(f"loops in turns on {PER_STEP_STEPS} steps: chunked {turns['chunked']} ms/step, "
          f"per-step {turns['per_step']} ms/step; chunked speedup "
          f"{record['chunked_speedup']:.3f}x")

    dev = torch.device("cuda")
    labels_d, adj_d = trainer.corpus_to_device(train_c, dev, log=lambda line: None)
    perm = np.random.default_rng(SEED).permutation(len(train_c))[: (PROFILE_STEPS + 2) * b]
    block = torch.as_tensor(perm.reshape(PROFILE_STEPS + 2, b), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state, _ = trainer.chunk_step(state, labels_d, adj_d, block[:2], gen)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.chunk_step(state, labels_d, adj_d, block[2:], gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    # device work only: user annotations (e.g. the optimizer step's range) span kernels
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("train step profile: the profiler recorded no device events (not measured)")
        return record
    by_name: dict = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    device_ms = sum(us for us, _ in by_name.values()) / 1e3 / PROFILE_STEPS
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    record.update({
        "profile_steps": PROFILE_STEPS,
        "profiled_wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_events_per_step": len(kernels) / PROFILE_STEPS,
        "device_busy_share": device_ms / step_ms,
        "top_kernels": [
            {"name": name[:100], "ms_per_step": us / 1e3 / PROFILE_STEPS,
             "per_step": count / PROFILE_STEPS}
            for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        ],
        "top_host_ops_profiled": [
            {"name": a.key[:100], "self_cpu_ms_per_step": a.self_cpu_time_total / 1e3 / PROFILE_STEPS,
             "per_step": a.count / PROFILE_STEPS}
            for a in host
        ],
    })
    print(f"train step profile: {record['device_events_per_step']:.0f} device events and "
          f"{device_ms:.3f} ms of device time per step; the chunked step above takes "
          f"{step_ms:.3f} ms, so the device is busy {100 * record['device_busy_share']:.1f}% "
          f"of it (profiled wall {wall_ms:.3f} ms per step)")
    for k in record["top_kernels"]:
        print(f"  device {k['ms_per_step']:.3f} ms/step in {k['per_step']:.0f} launches: {k['name']}")
    for k in record["top_host_ops_profiled"]:
        print(f"  host (profiled) {k['self_cpu_ms_per_step']:.3f} ms/step in {k['per_step']:.0f} "
              f"calls: {k['name']}")
    return record


def kernel_records(er: dict, decoded: dict, launches_by_path: dict) -> list:
    """The kernels' records: times, plain times and bounds on the decoded
    population (the search's inputs), ER-candidate times beside them;
    ``launches`` sums the main paths' runs, each read on its own."""
    def record(name, key, plain_key, library_ms, extra):
        return {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": sum(path[name] for path in launches_by_path.values()),
            "launches_by_path": {p: path[name] for p, path in launches_by_path.items()},
            "max_abs_err": max(er[f"err_{key}"], decoded[f"err_{key}"]),
            "ms": decoded[f"{key}_ms"],
            "plain_ms": decoded[plain_key],
            "bound_ms": decoded[f"{key}_bound_ms"],
            "bound_by": decoded[f"{key}_bound_by"],
            "library_ms": library_ms,
            "inputs": "decoded population",
            "ms_er": er[f"{key}_ms"],
            "plain_ms_er": er[plain_key],
            "bound_ms_er": er[f"{key}_bound_ms"],
            "bytes": decoded[f"{key}_bytes"],
            "int_ops": decoded[f"{key}_int_ops"],
            **extra,
        }

    return [
        record("contingency_counts_fused", "fused", "fused_plain_ms", None, {
            "before_ms": decoded["before_ms"], "before_ms_er": er["before_ms"],
            "small_span_ms": decoded["small_span_ms"], "small_span_ms_er": er["small_span_ms"],
        }),
        record("contingency_counts", "seg", "seg_plain_ms", decoded["bincount_ms"], {
            "library_ms_er": er["bincount_ms"],
        }),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "dags_vae_search_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout holding dags_vae_search_tpu_torch/", file=sys.stderr)
        return 2

    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
    from dags_vae_search_tpu_torch.scoring.bic import BicScorer
    from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem

    t_start = time.perf_counter()
    name, clock_hz = phase_device(torch)
    cfg = REGISTRY["alarm"]
    _, dataset = make_synthetic_problem(
        cfg.name, num_cases=cfg.simulate_cases, max_card=cfg.simulate_max_card, seed=cfg.seed
    )
    scorer = BicScorer(dataset, max_parents=cfg.search.max_parents, device="cuda")
    check(scorer.impl == "kernel", "the card scorer does not use the kernel")
    print(
        f"alarm data: {dataset.num_cases} cases, {scorer.num_unique_rows} unique rows, "
        f"q_cap={scorer.q_cap}, r_max={scorer.r_max}"
    )

    er = phase_kernels(torch, cfg, scorer, clock_hz)
    phase_card_vs_cpu(torch, cfg, scorer, dataset)
    phase_train_card_vs_cpu(torch)
    search, decoded = phase_search(torch, cfg, scorer, clock_hz)
    print("search:", json.dumps(search))
    trainer, state, train_c, test_c, train = phase_train(torch, cfg)
    train["eval"] = phase_checkpoint_eval(torch, cfg, state.model, test_c)
    train["search"] = phase_train_search(torch, cfg, scorer, state.model)
    train["step_time"] = phase_step_time(torch, cfg, trainer, state, train_c)
    print("train:", json.dumps(train))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    launches_by_path = {
        "search": search["kernel_launches"],
        "train_chunked": train["chunked"]["launches"],
        "train_per_step": train["per_step"]["launches"],
        "train_search": train["search"]["kernel_launches"],
    }
    print(json.dumps({"kernels": kernel_records(er, decoded, launches_by_path)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
