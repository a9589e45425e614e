#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dags_vae_search_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX.  Phases, in
order; any failure exits non-zero:

1. device  — the card's name and power limit;
2. kernels — builds ``csrc/contingency_counts.cu``, runs it at the alarm
   search shape (2048 candidates x 37 nodes x 4,973 unique rows x 512 cells)
   against its plain torch version (bit-equal), and times the kernel, the
   plain version and one ``torch.bincount`` yardstick with CUDA events;
3. card vs CPU — counts (exact) and scores (f32 tolerance, float64 exact
   path to 1e-9) of 64 candidates against the CPU plain scorer, and the
   alarm-width model's loss on a small batch against the CPU;
4. search  — the alarm-width CEM latent search (registry width, seeded
   random weights) for 3 iterations of 2048 candidates, with the
   contingency kernel's launch count read from that run alone.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it holds the kernels' JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
CEM_ITERS = 3
#: Published H100 SXM peaks: HBM bytes/s and float32 (non-tensor-core) FLOP/s.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


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


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_kernels(torch, cfg, scorer) -> dict:
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.ops import _build, bic_kernel, bic_torch

    n, pop = cfg.num_vertices, cfg.search.cem_population
    rng = np.random.default_rng(SEED)
    # 2n edges, as the TPU bench sampled candidates; in-degree capped like decodes
    _, adj_np = sampler.sample_er_batch(
        rng, pop, n, 2 * n, n, max_in_degree=cfg.search.max_parents
    )
    adj = torch.as_tensor(adj_np, device="cuda")
    strides, _ = bic_torch.parent_config_strides(adj, scorer._cards)
    seg = bic_torch.cell_index(scorer._codes_u, strides, scorer.q_cap, scorer.r_max)
    seg = seg.reshape(pop * n, -1).contiguous()
    w = scorer._weights
    S = scorer.q_cap * scorer.r_max
    R, U = seg.shape
    print(f"kernel shape: R={R} (B={pop} x n={n}) U={U} S={S}")

    t0 = time.perf_counter()
    _build.load("contingency_counts")
    print(f"contingency_counts build+load {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("contingency_counts", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())

    out_k = bic_kernel.contingency_counts_kernel(w, seg, S)
    torch.cuda.synchronize()
    out_p = bic_kernel.contingency_counts_plain(w, seg, S)
    # integer counts below 2^24 are exact in f32 in any order: tolerance 0
    check(torch.equal(out_k, out_p), "kernel counts differ from the plain version")
    max_abs_err = float((out_k - out_p).abs().max())
    print(f"kernel vs plain: max |diff| {max_abs_err} (tolerance 0, bit-equal)")
    total = float(out_k.sum(dtype=torch.float64))
    check(total == float(w.sum(dtype=torch.float64)) * R, "counts do not sum to the cases")
    del out_k, out_p

    flat = (torch.arange(R, device="cuda", dtype=torch.int64)[:, None] * S + seg).reshape(-1)
    w_rep = w.expand(R, U).reshape(-1)
    ms = cuda_ms(lambda: bic_kernel.contingency_counts_kernel(w, seg, S), reps=20)
    plain_ms = cuda_ms(lambda: bic_kernel.contingency_counts_plain(w, seg, S), reps=3, warmup=1)
    library_ms = cuda_ms(
        lambda: torch.bincount(flat, weights=w_rep, minlength=R * S), reps=3, warmup=1
    )
    del flat, w_rep
    bytes_moved = R * U * 4 + U * 4 + R * S * 4
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = R * U / H100_F32_FLOPS * 1e3
    return {
        "name": "contingency_counts",
        "route": "cuda",
        "source": "dags_vae_search_tpu_torch/csrc/contingency_counts.cu",
        "replaces": "dags_vae_search_tpu/ops/bic_pallas.py:46",
        "launches": None,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "bytes": bytes_moved,
    }


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


def phase_search(torch, cfg, scorer) -> dict:
    from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
    from dags_vae_search_tpu_torch.models.pace_vae import make_model, num_parameters
    from dags_vae_search_tpu_torch.ops import bic_kernel
    from dags_vae_search_tpu_torch.search.latent import _relabel_and_check, cem_search

    model = make_model(SEED, "cuda", **cfg.model_kwargs())
    params = num_parameters(model)
    check(params == 16_260_634, f"alarm model has {params} parameters, want 16,260,634")
    pop = cfg.search.cem_population

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bic_kernel.contingency_counts_kernel.launches = 0
    t0 = time.perf_counter()
    result = cem_search(model, scorer, seed=SEED, iters=CEM_ITERS, population=pop, device="cuda")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = bic_kernel.contingency_counts_kernel.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(launches == CEM_ITERS, f"kernel launched {launches} times in {CEM_ITERS} iterations")
    check(np.isfinite(result.best_score), f"best BIC {result.best_score} is not finite")
    check(result.num_evals == CEM_ITERS * pop, "evaluation count")
    check(
        sorted(result.best_labels.tolist()) == list(range(cfg.num_vertices)),
        "best labels are not a permutation",
    )
    check(all(b >= a for a, b in zip(result.history, result.history[1:])), "history decreased")
    # the best graph re-scored exactly from its labels, in float64 on the card
    best_cols = _relabel_and_check(
        torch.as_tensor(result.best_labels[None], device="cuda"),
        torch.as_tensor(result.best_adj[None], device="cuda"),
    )[0]
    exact = float(scorer.score_exact(best_cols)[0])
    check(abs(exact - result.best_score) <= 1e-5 * abs(exact), f"best {result.best_score} vs exact {exact}")

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
    return {
        "params": params,
        "population": pop,
        "iters": CEM_ITERS,
        "evals": result.num_evals,
        "best_bic": result.best_score,
        "best_bic_exact": exact,
        "history": result.history,
        "search_s": search_s,
        "candidates_per_s": result.num_evals / search_s,
        "decode_ms_per_iter": decode_ms,
        "score_ms_per_iter": score_ms,
        "valid_decode_fraction": valid_frac,
        "finite_score_fraction": finite_frac,
        "peak_mem_gib": peak_gib,
        "kernel_launches": launches,
    }


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
    name = phase_device(torch)
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

    record = phase_kernels(torch, cfg, scorer)
    phase_card_vs_cpu(torch, cfg, scorer, dataset)
    search = phase_search(torch, cfg, scorer)
    record["launches"] = search["kernel_launches"]
    print("search:", json.dumps(search))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
