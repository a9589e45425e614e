#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dags_vae_search_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX.  Phases, in
order; any failure exits non-zero:

1. device  — the card's name and power limit;
2. kernels — builds ``csrc/contingency_counts.cu`` and runs two of its
   entries at the alarm search shape (2048 candidates x 37 nodes x 4,973
   unique rows x 512 cells) on sampled ER candidates: the seg entry against
   its plain torch version, the fused entry against its plain version and
   against the seg entry (all bit-equal); times each entry, its plain
   version and the ``torch.bincount`` yardstick with CUDA events;
2b. route sweep — both routes of the fused, seg and family entries at
   S = 512 to 32,768 bins (``SWEEP_SHAPES``) and U = 698 / 5,000 unique
   rows of 11 / 70 variables (``SWEEP_ROWS``; seeded random codes), on 256
   candidates and on a 4,096-family chunk: the routes equal to each other
   and to the plain version, each timed in ``SWEEP_REPEATS`` alternating
   repeats; the crossover the rule in PERF.md reads from them beside
   ``bic_kernel.NARROW_MAX_BINS``;
3. card vs CPU — counts (exact) and scores (f32 tolerance, float64 exact
   path to 1e-9) of 64 candidates against the CPU plain scorer, and the
   alarm-width model's loss on a small batch against the CPU;
3b. train step, card vs CPU — a small model (dropout and noise off) from
   one seed takes 3 optimizer steps on the same batches on both devices,
   the clip active on the first; losses and parameters to rtol 1e-4;
4. search  — the alarm-width CEM latent search (registry width, seeded
   random weights) for 3 iterations of 2048 candidates, with each
   iteration's wall time and the kernels' launch counts read from that run
   alone, every launch of the score entry (the scorer's path: counts
   reduced to node scores on chip) held against its plain version as it
   happens (``SCORE_RTOL`` / ``SCORE_ATOL``; the check's seconds left out);
   then one more decoded population, timed by phase, on which the count
   entries are checked and timed again, and the score entry checked (two
   launches bit-equal) and timed: kernel, entry, plain version and added
   peak memory; then one decode of ``DECODE_HOLD_ROWS`` latents (the island
   decode's rows) with every launch of the decode-attention kernel held
   against its plain version on the same inputs (``DECODE_RTOL``), each
   timed beside it and its bound.  Here and in phases 7, 9, 10, 13, 14 and
   16 every path that decodes reads the kernel's launches from its own run:
   whole decodes, 2 x layers x (max_n - 1) launches each, counted in a
   device trace of the run where a decode may replay its CUDA graphs (which
   run the kernel without its wrapper), else a positive wrapper count;
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
   and host operations;
9. the search stage — the blocked and the squaring closure at n = 256, 300
   and 724 and batches ``CLOSURE_BATCHES`` (equal to each other and to the
   CPU, each timed), then the JAX package's ``stage_search`` step by step with
   the trained model and the registry's search settings (two iteration
   counts cut, ``ISLAND_ITERS`` and ``REFINE_ITERS``): dense hill climbing
   with restarts, one family-delta climb (the seg entry's path), island CEM
   in the 64-dim PCA subspace of the encoded test corpus, the polish climb,
   refine, the predictor dataset and the exact GP, GP-UCB ascent,
   closed-loop BO and the 512-eval budget comparison.  Each step's wall
   time, evals/s, best BIC and its float64 re-scores (kernel counts, and
   host counts without the kernel), peak memory and every entry's launches
   (from that step alone; every launch held against its plain version as
   it happens; the delta climb launching the family entry alone, the GP
   fit the fused entry alone for its float64 targets, every other step
   the score entry alone); then the fused entry held bit-equal to its plain
   version and the score entry timed as in phase 4 on a dense-climb chunk
   and an island population, and the family and the seg entry on four of
   the delta climb's chunks (first frontier, a one-child refresh, every
   child of its final graph, a full chunk), each route bit-equal to the
   plain version and timed beside it, ``torch.bincount`` on the cells and
   the bound;
10. the pipeline — the port's ``ExperimentRunner`` on the alarm experiment
   in a temporary data dir on the card, with phase 5's and phase 9's cuts
   (corpus batch 8, 2 epochs, checkpointed at the end of them, island CEM
   and refine iterations): generate, split, train, eval (exact equality, no
   networkx), predictor, gp, search, roundtrip, each stage's wall time, peak
   memory and both entries' launches read from that stage alone; then the
   CLI (``gp roundtrip``) in a subprocess over the same artifacts and the
   results page.  Checked: the npz corpus and splits read back bit-equal to
   phase 5's, every report in the runs dir and its ``reports_torch/``
   mirror, none skipped, the climb's best equal to its host re-score
   (``score_exact_sparse``) and to phase 9's to 1e-9, every latent best
   finite, the fused entry launched by search and predictor, the page naming
   the card;
11. wide rows at barley width — ``make_synthetic_problem("barley",
   max_card=16)`` scored with the registry's ``max_parents`` 8: q_cap 4,096,
   r_max 16, S = 65,536 bins per row, past one warp's shared memory, so both
   entries take their wide kernels.  A dense climb from the empty graph
   (``score_chunk`` 256, ``WIDE_CLIMB_STEPS`` steps, through the score
   entry's wide kernel) and a delta climb (its default chunk of 4,096
   families), every launch held, each best held to its float64 re-scores;
   the fused wide kernel held bit-equal to
   its plain version on a climb chunk, the score entry timed there as in
   phase 4, the family and seg wide kernels on
   the delta climb's chunks, each timed beside its plain version, its
   bound (the output's bytes) and ``torch.bincount``; launches per path;
   peak memory under 20 GiB; and rows of 512 bins shown still taking the
   narrow kernels;
12. the native codec at link width — ``native.load()`` must build the
   library; the two n = 724 npz parts read through it, and decoded by it and
   by numpy (bit-equal) in 10 pairs of alternating order, graphs/s for both;
13. data parallel at alarm width (one card, so no multi-card number): (a)
   a world-size-1 NCCL group, chunked steps of ``Trainer(mesh=...)``
   bit-identical to ``mesh=None``; (b) two gloo ranks sharing the card,
   dropout 0 and the same noise, 5 steps against one process whose every
   step starts from the two-rank run's state: losses to rtol 1e-4 / atol
   1e-5, each step's summed gradients to 1e-4 norm-wise, and each step's
   parameters to rtol 1e-4 / atol 1e-5, leaving out (and counting) the
   elements whose two gradients, at that step or before, differed by more
   than 1e-3 of the one-process one; (c)
   ``island_cem_search`` over the two ranks, 8 islands x 512, 2 iterations
   in mode decode, its best equal to one process's;
14. the registry's very-large tier at link width (n = 724, its model,
   training and search settings; simulated binary data from the runner's
   ``scoring_dataset``), cut in depth and counts only (``TIER_*``): the
   runner's ``generate`` and ``split`` stages (sampler at the tier's density
   cap, npz parts through the native codec), ``load_corpus`` (bit-packed);
   the registry's ``Trainer`` with float32 and then bfloat16 operands: a
   fit epoch, one timed chunk of ``steps_per_call`` steps, a
   ``utils.profiling.trace`` window for the device's busy share, and the
   eval-mode loss of a few test graphs against a CPU copy; checkpoint round
   trip (bit-equal) and eval (``valid_ratio_mode`` 1); ``decode_and_score``
   on a decoded population of islands x population latents, a decode of as
   many latents with every decode-attention launch held as in phase 4
   (d_head 8, up to 726 keys), one delta climb
   at the registry's accept batch under a wall cap, and one island CEM at
   the tier's islands x population.  Every fused and family launch of the
   search steps is held bit for bit against its plain version as it
   happens; each best equals its float64 re-scores; the fused entry is
   timed on the decoded population and the family and seg entries on the
   climb's chunks;
   the search steps' peak stays under ``TIER_PEAK_GIB``;
15. the registry's small tier, readout-free models (embed 32, 8 heads, 3
   layers, latent 32, no edge readout), cut in depth and counts only
   (``SMALL_*``, phase 9's island and refine iterations): (a) asia through
   the ``ExperimentRunner`` from ``generate`` (the full 220,000-graph
   corpus) to ``roundtrip``, fitting one epoch on the first
   ``SMALL_FIT_GRAPHS`` graphs of the train split; beside it one chunk of
   ``steps_per_call`` steps timed with the device's busy share, and one
   readout-free chunk on the card and on the CPU from the same seed; (b)
   sachs with three-state variables (q_cap 4,096, S = 12,288 cells a row,
   on the route ``route()`` picks), the structure search of a
   ``variant="structure"`` runner (the family table, exact DP, the dense
   climb with restarts by table gather), then the fused entry timed on a
   table chunk and an exact-DP chunk on both routes, and the score entry
   (which the table and the DP score through) on both as in phase 4; (c)
   synthetic_12 with
   one label: generate, split, the same fit, the search stage with the
   checkpoint (unconstrained decodes).  Every fused launch is held bit for
   bit against its plain version as it happens; each family table equals
   one built on the CPU (the ``-inf`` pattern identical, finite entries to
   1e-5 relative); each exact optimum has the CPU's family count and equals
   the CPU's optimum and its host re-score to 1e-9; every climb and latent
   best lies at or below it and equals its own float64 re-score to 1e-5;
   asia's reports are all present in both directories, none skipped; each
   entry's narrow and wide launches together equal the calls held;
16. the registry's large tier at hepar2 (n = 70: embed 64, 4 layers,
   latent 1,792, an edge readout of rank 64, 67,910,090 parameters), cut in
   depth and counts only (``LARGE_*``, phase 9's island and refine
   iterations): (a) the ``ExperimentRunner`` with the registry's binary
   simulated data (S = 512) from ``generate`` (the full 47,872-graph
   corpus, bit-packed on both splits: 9 bytes a row) to ``roundtrip``,
   fitting one epoch checkpointed at its end; beside it one chunk of
   ``steps_per_call`` steps timed with the device's busy share, and a
   3-step chunk of ``LARGE_PARITY_BATCH`` graphs on the card and on the CPU
   from the same seed (losses to rtol 1e-4 / atol 1e-5, gradients to 1e-4
   norm-wise, parameters where the two gradients agree, as phase 13b,
   every one within Adam's reach).  Checked: the corpus
   graphs forward DAGs within the in-degree cap with permutation labels;
   finite losses; the stage's checkpoint restores bit-equal; eval without
   networkx at ``valid_ratio_mode`` 1; every report present in both
   directories, none skipped; the search stage's delta climbs (accept
   batch 8, 4 restarts, tie stop 2) each non-decreasing, the restart
   history 1-5 entries none below the first; every best (climb, islands,
   polish, refine, GP ascent, BO) equal to its float64 re-score to 1e-5,
   the climb's also to the host's kernel-free re-score to 1e-9, the
   ground truth's BIC beside them; the GP the exact one; the climbs count
   through the family entry and never the seg entry; the family entry
   timed at the binary climbs' shapes (an accept batch's 8-child refresh,
   a full chunk).  (b) hepar2 with
   four-state variables (q_cap 4,096, S = 16,384 cells a row): a
   ``variant="structure"`` runner's search (the delta climbs with the
   registry's restarts; the latent half skipped), then both routes of all
   three entries timed, each bit-equal to its plain version, beside its
   bound: the family and seg entries on the climb's chunks (a full 4,096
   chunk among them), the fused entry on a population of
   ``LARGE_POPULATION`` DAGs with hepar2's 123 edges, and the score entry
   there as in phase 4.  Every score, fused, seg and family launch of both
   runners is held against its plain version as it happens (counts bit for
   bit), on the route ``route()`` picks.

Every bound is ``h100_bench/peaks.py``'s, the benchmark's yardstick: the
card's published peaks at its published clock (``score_bound`` and
``family_bound`` for the score and family entries, ``bound_of`` of the
bytes and operations counted here for the others).

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it holds the kernels' JSON record (the decode attention's, from phases 4
and 14; four entries, each with its narrow and its wide route), a
``route_sweep:`` line phase 2b, a ``train:`` line phases 5-8, a ``search_stage:``
line phase 9, a ``pipeline:`` line phase 10, and ``wide_rows:``,
``native_codec:`` and ``data_parallel:`` lines phases 11-13, a ``tier`` line
phase 14, a ``small_tier`` line phase 15 and a ``large_tier`` line phase
16.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
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
#: phase 9's cuts of the registry's search settings, iteration counts only:
#: island CEM 30 -> 6 iterations (one migration, every 5, and the full
#: temperature anneal), refine 15 -> 5
ISLAND_ITERS = 6
REFINE_ITERS = 5
#: families per seg-entry call of the delta climb (its default chunk)
DELTA_CHUNK = 4096
#: graphs per closure call in phase 9a
CLOSURE_BATCHES = (2, 16, 128, 512)
#: phase 10's runner stages, in order
PIPELINE_STAGES = ("generate", "split", "train", "eval", "predictor", "gp", "search", "roundtrip")
#: phase 12's codec timing: link width, graphs (in two npz parts), repeats
LINK_N, LINK_GRAPHS, LINK_REPS = 724, 64, 3
#: phase 12: native and numpy decodes per part, in alternating order
LINK_PAIRS = 10
#: the train-step check's model: the parity tests' small width, deterministic
SMALL_TRAIN = dict(num_real_vertices=5, real_label_cardinality=5, embed_size=16, num_heads=4,
                   num_layers=2, latent_size=16, fc_hidden=16, dropout=0.0, epsilon_scale=0.0,
                   edge_readout=True)
#: phase 11: the wide-row route at barley width (16-state variables)
WIDE_NAME, WIDE_MAX_CARD = "barley", 16
WIDE_CLIMB_CHUNK = 256
WIDE_CLIMB_STEPS = 20
WIDE_PEAK_GIB = 20.0
#: phase 13: optimizer steps of the two-rank check, islands x population x iterations
DP_STEPS = 5
DP_ISLANDS, DP_POPULATION, DP_ITERS = 8, 512, 2
#: phase 13: a parameter element's update is compared where the two runs'
#: summed gradients agree within this fraction of the one-process one
DP_GRAD_RTOL = 1e-3
#: phase 14: the registry's very-large tier at link width (n = 724) and its
#: cuts, depth and counts only: fit epochs 20 -> 1 (then one timed chunk of
#: ``steps_per_call`` steps per operand type), island CEM iterations 6 -> 2
#: and exploit repeats 32 -> 4, the delta climb's wall budget 1800 -> 30 s,
#: eval on one batch of 4 test graphs, and graphs per curriculum batch
#: 8 -> 1 (650 graphs of about 5,600 edges; 8 take minutes on the host)
TIER_NAME = "link"
TIER_CORPUS_BATCH = 1
#: parameters of the tier's model at link width (the JAX package's count)
TIER_PARAMS = 95_704_984
TIER_FIT_EPOCHS = 1
TIER_PROFILE_STEPS = 3
TIER_EVAL_GRAPHS = 4
TIER_ISLAND_ITERS = 2
TIER_EXPLOIT = 4
TIER_CLIMB_S = 30.0
#: candidates per call of the fused entry's plain version when a launch is
#: held (about 2 GB of float64 and int64 intermediates at n = 724)
TIER_HOLD_CANDIDATES = 16
#: phase 14's search steps stay below this peak (GiB)
TIER_PEAK_GIB = 20.0
#: phase 15: the registry's small tier (asia, sachs, synthetic_12) and its
#: cuts, depth and counts only: one fit epoch on the first SMALL_FIT_GRAPHS
#: graphs of the train split (10 chunks of 100 steps of 32; a full epoch of
#: asia's 6,187 steps is past 3 minutes on the card, a step host-bound at
#: about 30 ms) instead of 100 epochs on all of it, island CEM and refine
#: iterations as phase 9 cuts them; sachs simulated with three-state
#: variables (the reference's data are ternary; the registry simulates
#: binary data)
SMALL_FIT_GRAPHS = 32_000
SMALL_SACHS_STATES = 3
#: the registry's asia corpus (4,000 graphs x 55 curriculum batches) and its
#: train split
SMALL_ASIA_CORPUS, SMALL_ASIA_TRAIN = 220_000, 198_000
#: parameters of the tier's readout-free models (the port's count)
SMALL_PARAMS = {"asia": 284_556, "sachs": 303_759, "synthetic_12": 309_445}
#: steps of the readout-free chunk held card against CPU
SMALL_PARITY_STEPS = 3
#: phase 16: the registry's large tier at hepar2 (n = 70: embed 64, 4
#: layers, latent 1,792, edge readout of rank 64) and its cuts, depth and
#: counts only: fit epochs 100 -> 1 (checkpointed at its end), island CEM
#: and refine iterations as phase 9 cuts them, eval batches 20 -> 4; (b)
#: hepar2 simulated with four-state variables (q_cap 4,096, S = 16,384),
#: the structure search only
LARGE_NAME = "hepar2"
#: parameters of the tier's model at hepar2 (the JAX package's count)
LARGE_PARAMS = 67_910_090
#: the registry's hepar2 corpus (16 curriculum batches of 32 graphs per
#: edge count, the constructive sampler) and its train split
LARGE_CORPUS, LARGE_TRAIN = 47_872, 43_085
LARGE_FIT_EPOCHS = 1
LARGE_EVAL_BATCHES = 4
#: graphs a step of the chunk held card against CPU (a 67.9 M-parameter
#: model steps on the card's host too)
LARGE_PARITY_BATCH = 8
#: candidates per call of the fused entry's plain version when a launch is
#: held (about 1 GB of intermediates at n = 70)
LARGE_HOLD_CANDIDATES = 128
LARGE_STATES = 4
#: the fused entry's timed population at four states (R = 256 x 70 rows,
#: 1.17 GB of counts)
LARGE_POPULATION = 256
KERNELS = ("node_scores_fused", "node_scores_fused_wide", "contingency_counts_fused",
           "contingency_counts_fused_wide", "contingency_counts", "contingency_counts_wide",
           "contingency_counts_family", "contingency_counts_family_wide")
#: the score entry against its plain version: float32 sums of the same
#: terms in another order, within 1e-5 relative or 1e-3 absolute
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-3
#: the decode-attention kernel against its plain version: float32 sums of
#: the same terms in another order, within 1e-6 of the call's largest output
DECODE_RTOL = 1e-6
#: rows of phase 4's held decode: the island decode's 8 islands x 4,096
DECODE_HOLD_ROWS = 32_768
#: cycles the card sleeps ahead of each held decode-attention call, so that
#: the host has queued the kernel and the plain version before either runs
DECODE_SLEEP_CYCLES = 2_000_000
DECODE_SOURCE = "dags_vae_search_tpu_torch/csrc/decode_attention.cu"
#: phase 9's steps that decode latents
LATENT_STEPS = ("island_cem", "latent_refined", "gp_ascent", "bo", "budget_gp_ascent",
                "budget_bo", "budget_island_cem")
#: candidates a call of the score entry's plain version when phase 4 and
#: phase 9 hold their launches (rows of 512 bins), and phase 11 (65,536)
ALARM_HOLD_CANDIDATES, WIDE_HOLD_CANDIDATES = 512, 64
#: the route sweep (phase 2b): bins per row as (q_cap, r_max), the unique
#: rows with the variables of the dataset they stand for (sachs, hepar2),
#: repeats of each route's timing, calls a timing
SWEEP_SHAPES = {512: (256, 2), 2048: (512, 4), 4096: (1024, 4), 8192: (2048, 4),
                12_288: (3072, 4), 16_384: (4096, 4), 32_768: (4096, 8)}
SWEEP_ROWS = {698: 11, 5000: 70}
SWEEP_REPEATS, SWEEP_CALLS = 6, 50
#: the second amendment's margin: there the wide route led a point only when
#: its median was also this far below the narrow route's; the rule no longer
#: asks it (PERF.md), and the sweep prints that reading beside its own
SWEEP_MARGIN = 0.05
#: candidates of the fused entry's sweep input, families of the others'
SWEEP_CANDIDATES, SWEEP_FAMILIES = 256, 4096
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


def device_ms(fn, reps: int, warmup: int = 1, sleep_cycles: int = 20_000_000) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` back-to-back calls,
    the card held by a sleep kernel while the host queues them, so that the
    host's dispatch does not show where a call is shorter than it; the
    sleep doubles until the card is still asleep when the host is done."""
    import torch

    for _ in range(warmup):
        fn()
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / reps
        sleep_cycles *= 2
    raise RuntimeError("chip_smoke check failed: the host never fell behind the sleeping card")


def in_ms(bound: dict) -> dict:
    """A bound of ``h100_bench/peaks.py`` (the benchmark's yardstick: the
    card's published peaks at its published clock) with its time in ms."""
    out = dict(bound)
    out["bound_ms"] = out.pop("bound_s") * 1e3
    return out


def code_bytes(codes_cm) -> int:
    return codes_cm.numel() * codes_cm.element_size()


def fused_entry_bound(strides_t, codes_cm, w, S: int) -> dict:
    """The fused entry's bound: strides, codes and weights read once, counts
    written once; per row and unique row its parents' multiply-adds, the
    child and the bin."""
    from h100_bench import peaks

    R, U = strides_t.shape[0] * strides_t.shape[1], w.shape[0]
    nbytes = strides_t.numel() * 4 + code_bytes(codes_cm) + U * 4 + R * S * 4
    return in_ms(peaks.bound_of(nbytes, U * (float((strides_t > 0).sum()) + 2 * R)))


def seg_entry_bound(F: int, U: int, S: int) -> dict:
    """The seg entry's bound: F x U cells and U weights read, F x S counts
    written; one bin add per cell."""
    from h100_bench import peaks

    return in_ms(peaks.bound_of(F * U * 4 + U * 4 + F * S * 4, F * U))


def score_entry_bound(strides_t, codes_cm, w) -> dict:
    """The score entry's bound on one call's inputs: ``peaks.score_bound``."""
    from h100_bench import peaks

    b, n = strides_t.shape[:2]
    return in_ms(peaks.score_bound(b * n, n, w.shape[0], code_bytes(codes_cm),
                                   int((strides_t > 0).sum())))


def family_entry_bound(parents, codes_cm, U: int, S: int) -> dict:
    """The family entry's bound on one call's inputs: ``peaks.family_bound``."""
    from h100_bench import peaks

    F, P = parents.shape
    return in_ms(peaks.family_bound(F, P, codes_cm.shape[0], U, code_bytes(codes_cm), S,
                                    int((parents >= 0).sum())))


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    """The card's name."""
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(nvidia_smi("name,power.limit"))
    return name


def describe_rows(torch, adj, label: str) -> None:
    """In-degree histogram of the rows, and the share that takes the fused
    kernel's lane-private bins (binary data: span 2^(k+1) cells)."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    indeg = adj.sum(dim=1).reshape(-1).to(torch.int64)
    hist = torch.bincount(indeg, minlength=9).tolist()
    private = float((2 ** (indeg + 1) <= bic_kernel.SMALL_SPAN).float().mean())
    print(f"{label}: in-degree histogram {hist}, mean {float(indeg.float().mean()):.3f}, "
          f"rows on lane-private bins {private:.3f}")


def time_entries(torch, scorer, adj, label: str) -> dict:
    """Check both entries on the candidates ``adj`` (bit-equal to their plain
    versions and to each other) and time them, their plain versions and the
    ``torch.bincount`` yardstick; bounds from these inputs."""
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
    for key, bound in (("fused", fused_entry_bound(strides_t, codes_cm, w, S)),
                       ("seg", seg_entry_bound(R, U, S))):
        t.update({f"{key}_{k}": v for k, v in bound.items()})
    print(f"{label}: " + json.dumps(t))
    return t


def phase_kernels(torch, cfg, scorer) -> dict:
    from dags_vae_search_tpu_torch import native
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

    # the two sources build at once: nvcc for the kernels, g++ for the codec
    t0 = time.perf_counter()
    codec_build = threading.Thread(target=native.load)
    codec_build.start()
    _build.load("contingency_counts")
    print(f"contingency_counts build+load {time.perf_counter() - t0:.2f} s")
    codec_build.join()
    print(f"native codec build+load {time.perf_counter() - t0:.2f} s, "
          f"{'loaded' if native.load() is not None else 'FAILED: ' + native.build_log}")
    for line in _build.build_logs.get("contingency_counts", "").splitlines():
        if "entry function" in line or "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return time_entries(torch, scorer, torch.as_tensor(adj_np, device="cuda"), "ER candidates")


def sweep_inputs(torch, S: int, U: int, n: int) -> dict:
    """The route sweep's inputs at S bins and U unique rows of n variables
    with r_max states each, made from ``SEED``: every entry's arguments on
    the shapes the paths send it (``SWEEP_CANDIDATES`` DAGs with 2n edges
    for the fused entry; a delta-climb chunk of ``SWEEP_FAMILIES`` families,
    each a child and 0-8 parents in 9 slots, for the family entry, and its
    cells for the seg entry)."""
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch

    q_cap, r_max = SWEEP_SHAPES[S]
    rng = np.random.default_rng(SEED + S + U)
    codes_u = torch.as_tensor(rng.integers(0, r_max, size=(U, n)), dtype=torch.int32,
                              device="cuda")
    w = torch.as_tensor(rng.integers(1, 5, size=U), dtype=torch.float32, device="cuda")
    cards = torch.full((n,), r_max, dtype=torch.int32, device="cuda")
    codes_cm = bic_kernel.column_major_codes(codes_u, r_max)
    _, adj = sampler.sample_er_batch(rng, SWEEP_CANDIDATES, n, 2 * n, n, max_in_degree=8)
    strides, _ = bic_torch.parent_config_strides(torch.as_tensor(adj, device="cuda"), cards)
    children = rng.integers(0, n, size=SWEEP_FAMILIES).astype(np.int32)
    parents = np.full((SWEEP_FAMILIES, 9), -1, np.int32)
    for i, y in enumerate(children):
        k = rng.integers(0, min(9, n))
        parents[i, :k] = rng.choice(np.delete(np.arange(n), y), size=k, replace=False)
    family = (torch.as_tensor(children, device="cuda"), torch.as_tensor(parents, device="cuda"),
              codes_cm, cards, w.to(torch.int32), q_cap, r_max)
    seg, _ = bic_kernel.family_cells(family[0], family[1], codes_cm[:, :U], cards, q_cap, r_max)
    return {"fused": (strides.transpose(1, 2).contiguous(), codes_cm, w, q_cap, r_max),
            "seg": (w, seg, S), "family": family, "n": n}


def phase_route_sweep(torch) -> dict:
    """Phase 2b: both routes of each entry at every S of ``SWEEP_SHAPES``
    and each U of ``SWEEP_ROWS``: the two routes' counts equal to each other
    and to the plain version (tolerance 0), then ``SWEEP_REPEATS`` repeats
    of ``SWEEP_CALLS`` calls a route in turns (narrow first in odd repeats,
    wide first in even ones), each timed on the device alone
    (:func:`device_ms`).  The rule PERF.md states reads the record: the
    wide route is ahead at a point when it is faster in every repeat; an
    entry's crossover for a U is the smallest S from which it is ahead at
    every larger swept S; the narrow route keeps the S below the smaller
    crossover of the two U, or, where the two crossovers differ by more
    than 2x, the U * S up to the larger of the two U's last narrow points.
    What the rule reads is printed beside ``bic_kernel``'s constants, with
    the reading of its second amendment, which also asked the wide median
    to be ``SWEEP_MARGIN`` below the narrow one."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    launch = {
        "fused": lambda args, wide: bic_kernel._launch_fused(*args, wide=wide),
        "seg": lambda args, wide: bic_kernel._launch(*args, wide=wide),
        "family": lambda args, wide: bic_kernel._launch_family(*args, wide=wide)}
    plain = {"fused": lambda args: torch.cat([c for _, c in fused_plain_parts(args, 64)]),
             "seg": lambda args: bic_kernel.contingency_counts_plain(*args),
             "family": lambda args: bic_kernel.contingency_counts_family_plain(*args)}
    points = []
    for U, n in SWEEP_ROWS.items():
        for S in SWEEP_SHAPES:
            inputs = sweep_inputs(torch, S, U, n)
            for entry in ("fused", "seg", "family"):
                args = inputs[entry]
                narrow, wide = launch[entry](args, False), launch[entry](args, True)
                check(torch.equal(narrow, wide) and torch.equal(narrow, plain[entry](args)),
                      f"route sweep {entry} S={S} U={U}: the routes or the plain version differ")
                del narrow, wide
                times = {"narrow": [], "wide": []}
                for rep in range(SWEEP_REPEATS):
                    for name in (("narrow", "wide") if rep % 2 == 0 else ("wide", "narrow")):
                        times[name].append(device_ms(
                            lambda: launch[entry](args, name == "wide"), reps=SWEEP_CALLS))
                warp_bytes = {"fused": bic_kernel.fused_warp_bytes(S, n),
                              "seg": bic_kernel.seg_warp_bytes(S),
                              "family": bic_kernel.family_block_bytes(S, 9)}[entry]
                faster = all(w_ < n_ for n_, w_ in zip(times["narrow"], times["wide"]))
                margin = np.median(times["wide"]) <= (1 - SWEEP_MARGIN) * np.median(times["narrow"])
                points.append({"entry": entry, "U": U, "S": S, "narrow_ms": times["narrow"],
                               "wide_ms": times["wide"], "wide_ahead": bool(faster),
                               "wide_ahead_by_margin": bool(faster and margin),
                               "route": bic_kernel.route(entry, S, warp_bytes)})
            del inputs
            torch.cuda.empty_cache()
    swept = list(SWEEP_SHAPES)

    def reading(entry, ahead_key):
        crossover, last_narrow = {}, {}
        for U in SWEEP_ROWS:
            ahead = [p[ahead_key] for p in points if p["entry"] == entry and p["U"] == U]
            first = len(ahead)
            while first > 0 and ahead[first - 1]:
                first -= 1
            crossover[U] = swept[first] if first < len(ahead) else None
            last_narrow[U] = swept[first - 1] if first > 0 else None
        found = [c for c in crossover.values() if c is not None]
        if not found:
            reads = {"bins": 58_112}
        elif len(found) == len(crossover) and max(found) <= 2 * min(found):
            below = [S for S in swept if S < min(found)]
            reads = {"bins": below[-1] if below else 0}
        else:
            reads = {"rows_x_bins": max(U * S for U, S in last_narrow.items() if S)}
        return crossover, last_narrow, reads

    rule = {}
    for entry in ("fused", "seg", "family"):
        crossover, last_narrow, reads = reading(entry, "wide_ahead")
        constant = {"bins": bic_kernel.NARROW_MAX_BINS[entry]}
        rule[entry] = {"crossover_by_U": crossover, "last_narrow_by_U": last_narrow,
                       "rule_reads": reads, "module": constant, "agree": reads == constant,
                       "second_amendment_reads": reading(entry, "wide_ahead_by_margin")[2]}
    out = {"points": points, "rule": rule, "card": nvidia_smi("name,power.limit")}
    for p in points:
        print(f"route sweep {p['entry']:6s} U={p['U']:5d} S={p['S']:6d}: narrow "
              f"{min(p['narrow_ms']):.4f}-{max(p['narrow_ms']):.4f} ms, wide "
              f"{min(p['wide_ms']):.4f}-{max(p['wide_ms']):.4f} ms, wide ahead "
              f"{p['wide_ahead']}, route() {p['route']}")
    print("route_sweep:", json.dumps(out))
    return out


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


def _counters() -> dict:
    """Each route's wrapper, by its record name, and the decode's attention."""
    from dags_vae_search_tpu_torch.ops import bic_kernel, decode_attention

    return {"decode_attention": decode_attention.decode_attention,
            "node_scores_fused": bic_kernel.node_scores_fused,
            "node_scores_fused_wide": bic_kernel.node_scores_fused_wide,
            "contingency_counts_fused": bic_kernel.contingency_counts_fused,
            "contingency_counts_fused_wide": bic_kernel.contingency_counts_fused_wide,
            "contingency_counts": bic_kernel.contingency_counts_kernel,
            "contingency_counts_wide": bic_kernel.contingency_counts_wide,
            "contingency_counts_family": bic_kernel.contingency_counts_family,
            "contingency_counts_family_wide": bic_kernel.contingency_counts_family_wide}


#: the decode-attention kernels by name in a device trace (the register
#: kernel's instances and the kernel for any d_head)
DECODE_KERNEL = re.compile(r"\bdecode_attention(_any)?_kernel\b")

_decode_trace: list = []


def reset_launches(trace_decodes: bool = False) -> None:
    """Zero every wrapper's count.  With ``trace_decodes``, also start a
    device trace, from which the next :func:`read_launches` counts the
    decode-attention kernels the card ran: a decode that replays its CUDA
    graphs runs them without the wrapper, which counts its own launches."""
    for fn in _counters().values():
        fn.launches = 0
    if trace_decodes:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        _decode_trace.append(prof)


def read_launches() -> dict:
    """Each wrapper's launches since :func:`reset_launches`; the decode
    attention's from the device trace where that started one."""
    launches = {name: fn.launches for name, fn in _counters().items()}
    if _decode_trace:
        import torch

        prof = _decode_trace.pop()
        torch.cuda.synchronize()
        prof.stop()
        launches["decode_attention"] = sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and DECODE_KERNEL.search(e.name))
    return launches


def bic_launches(launches: dict) -> int:
    """The counts entries' launches, every route (the decode's left out)."""
    return sum(launches[name] for name in KERNELS)


def decode_calls(model) -> int:
    """Decode-attention launches of one sampling decode: self and cross
    attention of each decoder layer at each of its max_n - 1 positions."""
    return 2 * model.decoder.num_layers * (model.max_n - 1)


def check_decodes(launches: dict, model, label: str, decodes: int | None = None) -> None:
    """A path's decode-attention launches, read from its device trace, are
    ``decodes`` whole decodes (a positive number of them where None)."""
    got, per = launches["decode_attention"], decode_calls(model)
    ok = got == decodes * per if decodes is not None else got > 0 and got % per == 0
    check(ok, f"{label}: {got} decode-attention launches, want "
              f"{decodes if decodes is not None else 'whole'} decodes of {per}")


def hold_decode(torch, model, rows: int, label: str, max_in_degree: int | None = None) -> dict:
    """One sampling decode of ``rows`` seeded latents with every launch of
    the decode-attention kernel held against its plain version on the same
    inputs (the decode's own cache views and masks): the largest difference
    over the call's largest plain output within ``DECODE_RTOL``.  Each call
    is timed alone, the card asleep while the host queues the kernel and
    the plain version, by CUDA events around each; its bound is the bytes
    it must move (its admitted keys and values, the query, the mask column,
    the output).  The decode goes on with the kernel's outputs.  Totals by
    cache layout: the self-attention buffer and the memory's keys and
    values.  The decode runs over a workspace of its own, which captures no
    CUDA graph, so that its slot functions launch each kernel directly."""
    from dags_vae_search_tpu_torch.models import transformer
    from dags_vae_search_tpu_torch.models.decode import DecodeWorkspace
    from dags_vae_search_tpu_torch.ops import decode_attention as da
    from h100_bench import peaks

    check(model.matmul_dtype is None, f"{label}: the held decode is float32's")
    kernel = transformer.decode_attention
    layouts = {key: {"calls": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "keys": 0.0,
                     "admitted_keys": 0.0} for key in ("self", "cross")}
    worst = {"rel_err": 0.0, "late_calls": 0}

    def held(q, k, v, mask, matmul_dtype=None):
        b, h, length, d = k.shape
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda._sleep(DECODE_SLEEP_CYCLES)
        events[0].record()
        out = kernel(q, k, v, mask, matmul_dtype)
        events[1].record()
        want = da.decode_attention_plain(q, k, v, mask, matmul_dtype)
        events[2].record()
        worst["late_calls"] += int(events[0].query())
        events[2].synchronize()
        err = float((out - want).abs().max() / want.abs().max())
        check(err <= DECODE_RTOL, f"{label}: decode attention at L={length} differs from "
                                  f"the plain version by {err:.3g} of its largest output")
        worst["rel_err"] = max(worst["rel_err"], err)
        admitted = float(mask[:, :-1].sum()) + b
        rec = layouts["cross" if k.stride(2) == d else "self"]
        rec["calls"] += 1
        rec["ms"] += events[0].elapsed_time(events[1])
        rec["plain_ms"] += events[1].elapsed_time(events[2])
        rec["bytes"] += 4.0 * (2 * h * d * admitted + 2 * b * h * d + b * (length - 1))
        rec["keys"] += b * length
        rec["admitted_keys"] += admitted
        return out

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    z = torch.randn((rows, model.latent_size), generator=gen, device="cuda")
    before = da.decode_attention.launches
    workspace = DecodeWorkspace(model, rows, z.device, True, 1.0, max_in_degree)
    workspace.load(z, 1.0)
    was_training = model.training
    transformer.decode_attention = held
    try:
        with torch.no_grad():
            workspace.run(model.eval(), gen)
        torch.cuda.synchronize()
    finally:
        transformer.decode_attention = kernel
        model.train(was_training)
    calls = da.decode_attention.launches - before
    check(calls == decode_calls(model) == sum(r["calls"] for r in layouts.values()),
          f"{label}: {calls} decode-attention launches, want {decode_calls(model)}")
    for rec in layouts.values():
        rec.update(in_ms(peaks.bound_of(rec["bytes"], 0.0)))
        rec["admitted_share"] = rec.pop("admitted_keys") / rec.pop("keys")
    total = in_ms(peaks.bound_of(sum(r["bytes"] for r in layouts.values()), 0.0))
    out = {"rows": rows, "heads": model.decoder.layer0.self_attn.num_heads,
           "d_head": model.d_model // model.decoder.layer0.self_attn.num_heads,
           "positions": model.max_n - 1, "calls": calls, "max_rel_err": worst["rel_err"],
           "late_calls": worst["late_calls"],
           "ms": sum(r["ms"] for r in layouts.values()),
           "plain_ms": sum(r["plain_ms"] for r in layouts.values()), **total,
           "by_layout": layouts}
    print(f"{label}: decode attention held on {calls} launches (max {out['max_rel_err']:.3g} of "
          f"the largest output; {out['late_calls']} calls where the card woke first), "
          + json.dumps(out))
    return out


def check_exact(scorer, best_score: float, cols: np.ndarray) -> float:
    """The column-indexed best graph ``cols`` re-scored in float64 twice:
    ``score_exact`` (the card's kernel counts, float64 entropy) must equal
    the f32 best to 1e-5 relative, and ``score_exact_sparse`` (host group-by
    counts, no kernel) must equal it to 1e-9 relative, which holds the
    kernel's counts of every best independently."""
    check(np.isfinite(best_score), f"best BIC {best_score} is not finite")
    exact = float(scorer.score_exact(cols[None])[0])
    check(abs(exact - best_score) <= 1e-5 * abs(exact), f"best {best_score} vs exact {exact}")
    host = float(scorer.score_exact_sparse(cols[None])[0])
    check(abs(host - exact) <= 1e-9 * abs(host), f"exact {exact} vs host re-score {host}")
    return exact


def check_best_exact(torch, scorer, result, n: int) -> float:
    """:func:`check_exact` of a latent search's best, relabelled to columns."""
    from dags_vae_search_tpu_torch.search.latent import _relabel_and_check

    check(sorted(result.best_labels.tolist()) == list(range(n)), "best labels are not a permutation")
    best_cols = _relabel_and_check(
        torch.as_tensor(result.best_labels[None], device="cuda"),
        torch.as_tensor(result.best_adj[None], device="cuda"),
    )[0]
    return check_exact(scorer, result.best_score, best_cols[0].cpu().numpy())


def phase_search(torch, cfg, scorer) -> tuple:
    from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
    from dags_vae_search_tpu_torch.models.pace_vae import make_model, num_parameters
    from dags_vae_search_tpu_torch.search.latent import _relabel_and_check, cem_search

    model = make_model(SEED, "cuda", **cfg.model_kwargs())
    params = num_parameters(model)
    check(params == 16_260_634, f"alarm model has {params} parameters, want 16,260,634")
    pop = cfg.search.cem_population

    # each iteration ends in one score call: stamp its end (after a sync that
    # the iteration's argmax would make anyway) to get per-iteration times;
    # every score launch is held against its plain version inside the call,
    # and the stamps leave the comparisons' seconds out
    stamps = []
    score = scorer.score
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches(trace_decodes=True)
    with held_launches(torch, ALARM_HOLD_CANDIDATES) as held:
        def stamped_score(adj):
            out = score(adj)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter() - held["check_s"])
            return out

        scorer.score = stamped_score
        t0 = time.perf_counter()
        try:
            result = cem_search(model, scorer, seed=SEED, iters=CEM_ITERS, population=pop,
                                device="cuda")
            torch.cuda.synchronize()
        finally:
            del scorer.score
        search_s = time.perf_counter() - t0 - held["check_s"]
    launches = read_launches()
    check_held(launches, held, "CEM search")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    iter_s = np.diff([t0, *stamps]).tolist()
    for i, dt in enumerate(iter_s):
        print(f"CEM iteration {i}: {dt:.4f} s (to the end of its score call, the check left out)")

    check(len(stamps) == CEM_ITERS, f"{len(stamps)} score calls in {CEM_ITERS} iterations")
    check(launches["node_scores_fused"] == CEM_ITERS == held["score"]
          and bic_launches(launches) == CEM_ITERS,
          f"score kernel launched {launches['node_scores_fused']} times in {CEM_ITERS} "
          f"iterations: {launches}")
    check_decodes(launches, model, "CEM search", decodes=CEM_ITERS)
    check(result.num_evals == CEM_ITERS * pop, "evaluation count")
    check(all(b >= a for a, b in zip(result.history, result.history[1:])), "history decreased")
    exact = check_best_exact(torch, scorer, result, cfg.num_vertices)

    # one more population, timed by phase
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    z = torch.randn((pop, model.latent_size), generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset_launches(trace_decodes=True)
    t0 = time.perf_counter()
    recon, valid = decode_to_labeled(
        model, z, gen, max_in_degree=scorer.max_parents
    )
    relabeled, is_perm = _relabel_and_check(recon.labels, recon.adj)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    check_decodes(read_launches(), model, "one decoded population", decodes=1)
    t0 = time.perf_counter()
    scores = scorer.score(relabeled)
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t0) * 1e3
    valid_frac = float((valid & is_perm).float().mean())
    finite_frac = float(torch.isfinite(scores).float().mean())
    decoded = time_entries(torch, scorer, relabeled, "decoded candidates")
    decoded["score_entry"] = time_score_entry(torch, scorer, relabeled, "decoded candidates",
                                              chunk=ALARM_HOLD_CANDIDATES)
    decoded["decode_attention"] = hold_decode(torch, model, DECODE_HOLD_ROWS,
                                              "alarm island decode",
                                              max_in_degree=scorer.max_parents)
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
        "held": held,
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
    check(chunked_run["launches"] == per_step_run["launches"] == dict.fromkeys(_counters(), 0),
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
    return trainer, state, data.Corpus(labels, adj), train_c, test_c, record


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
    reset_launches(trace_decodes=True)
    t0 = time.perf_counter()
    result = cem_search(model, scorer, seed=SEED, iters=1, population=pop, device="cuda")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["node_scores_fused"] == 1 and bic_launches(launches) == 1,
          f"score kernel launched {launches['node_scores_fused']} times in one iteration")
    check_decodes(launches, model, "trained-model CEM iteration", decodes=1)
    exact = check_best_exact(torch, scorer, result, cfg.num_vertices)
    print(f"trained-model CEM iteration: {pop} candidates in {search_s:.3f} s, best BIC "
          f"{result.best_score:.2f} (float64 {exact:.4f}), launches {launches}")
    return {"best_bic": result.best_score, "best_bic_exact": exact, "search_s": search_s,
            "candidates_per_s": pop / search_s, "kernel_launches": launches}


def device_time(torch, prof) -> tuple:
    """Device kernels of a profiler window (user annotations, which span
    kernels, left out): their total ms, their count, and (us, count) by name."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return sum(us for us, _ in by_name.values()) / 1e3, len(kernels), by_name


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
    device_ms, events, by_name = device_time(torch, prof)
    if not events:
        print("train step profile: the profiler recorded no device events (not measured)")
        return record
    device_ms /= PROFILE_STEPS
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    record.update({
        "profile_steps": PROFILE_STEPS,
        "profiled_wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_events_per_step": events / PROFILE_STEPS,
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


def phase_large_closure(torch) -> dict:
    """Phase 9a: the blocked and the squaring closure on the card at n = 256
    (the JAX package's switch), 300 and 724, at the batches the model sees
    there (2; 16, the registry's train batch of the largest nets; 128 and
    512, encode batches), on both sides of ``BLOCKED_CLOSURE_WORK``: equal
    to each other at every batch and to the CPU's blocked closure at batch 2
    (0/1 results: tolerance 0), each timed beside the route
    ``attention_allowed`` takes."""
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.graphs.dag import BLOCKED_CLOSURE_WORK, transitive_closure
    from dags_vae_search_tpu_torch.ops.reachability import closure_blocked

    out = {}
    for n in (256, 300, 724):
        gen = torch.Generator(device="cuda").manual_seed(SEED + n)
        adj = sampler.sample_er_dags(gen, max(CLOSURE_BATCHES), n, 2 * n, n,
                                     require_connected=False, num_attempts=1)[1]
        want = closure_blocked(adj[:2].cpu())
        for batch in CLOSURE_BATCHES:
            adj_b = adj[:batch].contiguous()
            got = closure_blocked(adj_b)
            check(torch.equal(got, transitive_closure(adj_b)),
                  f"n={n}, batch {batch}: blocked closure differs from the squaring closure")
            check(torch.equal(got[:2].cpu(), want),
                  f"n={n}: blocked closure on the card differs from the CPU's")
            out[f"n{n}_b{batch}"] = {
                "route": "blocked" if batch * n**3 >= BLOCKED_CLOSURE_WORK else "squaring",
                "blocked_ms": cuda_ms(lambda: closure_blocked(adj_b), reps=3, warmup=1),
                "squaring_ms": cuda_ms(lambda: transitive_closure(adj_b), reps=3, warmup=1),
                "reachable_pairs_per_graph": float(got.sum()) / batch}
            del got, adj_b
        del adj
    print(f"closures of DAGs with 2n edges: blocked = squaring at every batch, = CPU at batch 2 "
          f"(tolerance 0); {json.dumps(out)}")
    return out


def picked_cluster(args) -> int | str:
    """The cluster size the family entry's wrapper gives ``args`` (the
    entry's positional arguments), or "wide" where it takes the wide route."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    _, parents, codes_cm, _, w, q_cap, r_max = args
    S = q_cap * r_max
    if bic_kernel.route("family", S, bic_kernel.family_block_bytes(S, parents.shape[1])) == "wide":
        return "wide"
    return bic_kernel._family_cluster(parents, codes_cm, w, q_cap, r_max)


def ptxas_report(source: str = "contingency_counts") -> dict:
    """Registers, stack, spills and static shared memory of each kernel of
    ``csrc/<source>.cu`` from this run's ``nvcc -Xptxas -v`` output, by
    mangled name (empty when the library was built earlier)."""
    from dags_vae_search_tpu_torch.ops import _build

    out: dict = {}
    name = None
    for line in _build.build_logs.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in line:
            out[name]["stack_and_spills"] = line.strip()
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = line.split(":", 1)[1].strip()
    return out


def time_family_seg(torch, fam, final_adj: np.ndarray, max_rows=None,
                    refresh_children=None) -> dict:
    """The family entry (what the delta climb calls) and the seg entry at
    the climb's shapes, each built by the climb's own ``refresh_families``:
    its first frontier (every single-parent family of the empty graph), a
    one-child refresh, and a refresh of every child of the climb's final
    graph (multi-parent families, up to ``max_parents`` parents); then a
    full ``DELTA_CHUNK`` of such families, and where ``refresh_children``
    is given, the refresh of that many children of the final graph (an
    accept batch's).  ``max_rows`` keeps the first rows of each (the climb's
    own chunks at large n).  Each route of both entries (the narrow one
    where it fits a block) held bit-equal to the plain version (tolerance 0)
    and timed, the family narrow kernel held also at every cluster size and
    lane-private spans 0, 16 and 64, the family entry's route also on the device alone
    (:func:`device_ms`), beside the family entry's plain version, the
    ``torch.bincount`` yardstick on the cells, and both entries' bounds from
    this input.  The family kernels get the scorer's int32 multiplicities,
    as the climb sends them."""
    from dags_vae_search_tpu_torch.ops import bic_kernel
    from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

    n = fam.dataset.num_variables
    empty = np.zeros((n, n), bool)
    w, q_cap, r_max = fam._weights, fam.q_cap, fam.r_max
    S = q_cap * r_max
    shapes = [("first", empty, range(n)), ("refresh", empty, [0]),
              ("final", final_adj > 0, range(n))]
    chunks = {key: refresh_families(adj, ys, fam.max_parents)[:2] for key, adj, ys in shapes}
    # a full chunk of real families, the shape a climb above n = 64 sends:
    # the first frontier's and the final refresh's families, cycled
    children, parents = (np.concatenate([chunks["first"][i], chunks["final"][i]]) for i in (0, 1))
    chunks["full"] = (np.resize(children, DELTA_CHUNK),
                      np.resize(parents, (DELTA_CHUNK, parents.shape[1])))
    if refresh_children:
        chunks[f"refresh_{refresh_children}"] = refresh_families(
            final_adj > 0, range(refresh_children), fam.max_parents)[:2]
    t = {}
    for key, (children, parents) in chunks.items():
        children = np.asarray(children, np.int32)[:max_rows]
        parents = np.asarray(parents, np.int32)[:max_rows]
        args = (*fam._families(children, parents), fam._codes_cm, fam._cards,
                fam._multiplicities, q_cap, r_max)
        seg = fam.cells(children, parents)[0]
        F, U = seg.shape
        P = parents.shape[1]
        want = bic_kernel.contingency_counts_plain(w, seg, S)
        check(torch.equal(bic_kernel.contingency_counts_family_plain(*args), want),
              f"family {key} chunk: the family entry's plain version differs from the seg path")
        runs = {"family_wide": lambda: bic_kernel._launch_family(*args, wide=True),
                "seg_wide": lambda: bic_kernel._launch(w, seg, S, wide=True)}
        if bic_kernel.family_block_bytes(S, P) <= bic_kernel.MAX_SHARED_BYTES:
            runs["family_narrow"] = lambda: bic_kernel._launch_family(*args)
            for c in bic_kernel.FAMILY_CLUSTER_SIZES:
                for span in (0, 16, 64):
                    check(torch.equal(bic_kernel._launch_family(*args, cluster=c, private_span=span),
                                      want), f"family {key} chunk: the narrow kernel at cluster "
                                             f"{c}, lane-private span {span} differs from the "
                                             f"plain version")
        if bic_kernel.seg_warp_bytes(S) <= bic_kernel.MAX_SHARED_BYTES:
            runs["seg_narrow"] = lambda: bic_kernel._launch(w, seg, S)
        rec = {"F": F, "U": U, "S": S, "P": P,
               "max_parents_in_chunk": int((parents >= 0).sum(1).max()),
               "family_route": bic_kernel.route("family", S, bic_kernel.family_block_bytes(S, P)),
               "seg_route": bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S))}
        err = 0.0
        for name, run in runs.items():
            got = run()
            check(torch.equal(got, want), f"family {key} chunk: {name} differs from the plain version")
            err = max(err, float((got - want).abs().max()))
            rec[f"{name}_ms"] = cuda_ms(run, reps=20)
        del got
        flat = (torch.arange(F, device="cuda", dtype=torch.int64)[:, None] * S + seg).reshape(-1)
        w_rep = w.expand(F, U).reshape(-1)
        rec.update({
            "err": err,
            "ms": rec[f"family_{rec['family_route']}_ms"],
            # the entry's route on the device alone: a small call is shorter
            # than the host's dispatch of it
            "device_ms": device_ms(runs[f"family_{rec['family_route']}"], reps=SWEEP_CALLS),
            "seg_ms": rec[f"seg_{rec['seg_route']}_ms"],
            "family_plain_ms": cuda_ms(lambda: bic_kernel.contingency_counts_family_plain(*args),
                                       reps=3, warmup=1),
            "seg_plain_ms": cuda_ms(lambda: bic_kernel.contingency_counts_plain(w, seg, S),
                                    reps=3, warmup=1),
            "bincount_ms": cuda_ms(lambda: torch.bincount(flat, weights=w_rep, minlength=F * S),
                                   reps=3, warmup=1),
            "cluster": picked_cluster(args),
            **family_entry_bound(args[1], fam._codes_cm, U, S),
            "seg_bound": seg_entry_bound(F, U, S),
        })
        t[key] = rec
        del flat, w_rep, seg, want
    print("family and seg entries at the delta climb's shapes: " + json.dumps(t))
    return t


def fused_plain_parts(args, chunk=None):
    """The fused entry's plain version on ``args``, ``chunk`` candidates a
    call (all at once when None): a list of (first row, counts)."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    strides_t, rest = args[0], args[1:]
    b, n = strides_t.shape[:2]
    step = chunk or b
    return [(i * n, bic_kernel.contingency_counts_fused_plain(strides_t[i:i + step], *rest))
            for i in range(0, b, step)]


def score_plain(torch, args, kwargs, chunk=None):
    """The score entry's plain version on one call's arguments (``args[0]``
    the candidates), ``chunk`` candidates a call: node scores f32[B, n]."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    adj, rest = args[0], args[1:]
    step = chunk or adj.shape[0]
    return torch.cat([bic_kernel.node_scores_fused_plain(adj[i:i + step], *rest, **kwargs)[0]
                      for i in range(0, adj.shape[0], step)])


def scores_err(torch, got, want, label: str) -> float:
    """The score entry's node scores ``got`` against its plain version's
    ``want``: within ``SCORE_RTOL`` relative or ``SCORE_ATOL`` absolute
    where finite, equal where not; returns the largest difference."""
    finite = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), finite) and torch.equal(got[~finite], want[~finite]),
          f"{label}: the score kernel's non-finite scores differ from the plain version's")
    diff = (got[finite] - want[finite]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= SCORE_ATOL + SCORE_RTOL * want[finite].abs()).all()),
          f"{label}: the score kernel differs from its plain version by up to {err}")
    return err


def added_peak_gib(torch, fn) -> float:
    """Device memory ``fn()`` takes at its peak above what was allocated
    before it, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def time_score_entry(torch, scorer, adj, label: str, chunk=None) -> dict:
    """The score entry on one input of a main path: within tolerance of its
    plain version (``chunk`` candidates a plain call), two launches
    bit-equal, its kernel timed alone and the entry timed with the strides
    it computes first, its added peak memory, the plain version's time and
    the bound from this input."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    args = (adj, scorer._codes_u, scorer._weights, scorer._cards, scorer.q_cap, scorer.r_max,
            scorer.dataset.num_cases, scorer.metric)
    kwargs = {"codes_cm": scorer._codes_cm}
    S = scorer.q_cap * scorer.r_max
    _, tiles = bic_kernel.score_tiles(scorer.q_cap, scorer.r_max)
    out = {"rows": adj.shape[0] * adj.shape[1], "S": S, "tiles": tiles,
           "route": bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, adj.shape[-1]))}

    def entry():
        return bic_kernel.node_scores_fused(*args, **kwargs)[0]

    got = entry()
    again = entry()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{label}: two launches of the score kernel differ")
    out["err"] = scores_err(torch, got, score_plain(torch, args, kwargs, chunk), label)
    strides_t, q, codes_cm = bic_kernel._score_inputs(adj, None, scorer._cards, scorer.r_max,
                                                      scorer._codes_cm)
    kernel_args = (strides_t, q, codes_cm, scorer._weights, scorer._cards, scorer.q_cap,
                   scorer.r_max, scorer.dataset.num_cases, scorer.metric, 1.0)

    def launch():
        return bic_kernel._launch_scores(*kernel_args, wide=out["route"] == "wide")

    check(torch.equal(launch(), got), f"{label}: the kernel differs from the entry")
    # the kernel alone, without the strides the entry computes first
    out.update(kernel_ms=cuda_ms(launch, reps=10), entry_ms=cuda_ms(entry, reps=10),
               peak_gib=added_peak_gib(torch, entry),
               plain_ms=cuda_ms(lambda: score_plain(torch, args, kwargs, chunk), reps=2, warmup=1),
               **score_entry_bound(strides_t, codes_cm, scorer._weights))
    print(f"{label}: score kernel vs plain max |diff| {out['err']:.3g} (rtol {SCORE_RTOL}, atol "
          f"{SCORE_ATOL}), two launches bit-equal; " + json.dumps(out))
    return out


def check_fused(torch, got, args, label: str, chunk=None) -> float:
    """``got``, the fused entry's counts on ``args``, against its plain
    version (tolerance 0); returns the largest difference."""
    err = 0.0
    for row, want in fused_plain_parts(args, chunk):
        part = got[row:row + want.shape[0]]
        check(torch.equal(part, want), f"{label}: fused kernel differs from its plain version "
                                       f"from row {row}")
        err = max(err, float((part - want).abs().max()))
    return err


def hold_fused(torch, scorer, adj, label: str, chunk=None) -> dict:
    """The fused entry on one input that a search-stage path sends it:
    bit-equal to its plain version (tolerance 0, run ``chunk`` candidates a
    call), timed beside it, with its bound from this input."""
    from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch

    strides, _ = bic_torch.parent_config_strides(adj, scorer._cards)
    args = (strides.transpose(1, 2).contiguous(), scorer._codes_cm, scorer._weights,
            scorer.q_cap, scorer.r_max)
    got = bic_kernel.contingency_counts_fused(*args)
    out = {"rows": adj.shape[0] * adj.shape[1], "err": check_fused(torch, got, args, label, chunk),
           "ms": cuda_ms(lambda: bic_kernel.contingency_counts_fused(*args), reps=10),
           "plain_ms": cuda_ms(lambda: fused_plain_parts(args, chunk), reps=2, warmup=1),
           **fused_entry_bound(*args[:3], scorer.q_cap * scorer.r_max)}
    del got
    S = scorer.q_cap * scorer.r_max
    if bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, adj.shape[-1])) == "narrow":
        describe_rows(torch, (adj > 0).float(), label)
    print(f"{label}: fused kernel vs plain max |diff| {out['err']} (tolerance 0); "
          + json.dumps(out))
    return out


def phase_search_stage(torch, cfg, scorer, dataset, model, test_c) -> dict:
    """Phase 9: the search stage (the JAX package's ``runner.py`` stage_search)
    at alarm width with the trained model.  Every step runs alone: launches
    reset before it and read after it, before its best is re-scored.  Then
    the seg entry is timed at the delta climb's shape."""
    from dags_vae_search_tpu_torch.scoring.bic import relabel_to_columns
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
    from dags_vae_search_tpu_torch.search import hillclimb, islands, latent
    from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb
    from dags_vae_search_tpu_torch.surrogate.dataset import build_predictor_dataset
    from dags_vae_search_tpu_torch.surrogate.gp import ExactGP

    s, n, seed = cfg.search, cfg.num_vertices, cfg.seed
    steps: dict = {}
    fam = FamilyBatchScorer(dataset, max_parents=s.max_parents, q_cap=scorer.q_cap, device="cuda")

    def climb(init_adj=None):
        return hillclimb.hill_climb(scorer, n, init_adj=init_adj, max_iters=s.hill_climb_iters)

    def climb_exact(res) -> float:
        check(all(b >= a for a, b in zip(res.history, res.history[1:])), "climb history decreased")
        return check_exact(scorer, res.best_score, res.best_adj)

    def latent_exact(res) -> float:
        check(all(b >= a for a, b in zip(res.history, res.history[1:])), "history decreased")
        return check_best_exact(torch, scorer, res, n)

    def to_columns(labels, adj) -> np.ndarray:
        out = np.zeros_like(adj)
        out[np.ix_(labels, labels)] = adj
        return out

    def step(name, fn, exact_of=None, evals=None, **extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(trace_decodes=name in LATENT_STEPS)
        with held_launches(torch, ALARM_HOLD_CANDIDATES) as held:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        info = {"seconds": seconds, "seconds_without_checks": seconds - held["check_s"],
                "launches": read_launches(), "held": held,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        check_held(info["launches"], held, name)
        if exact_of is not None:
            evals = res.num_evals
            info.update(best_bic=res.best_score, best_bic_exact=exact_of(res), evals=evals,
                        history_len=len(res.history))
        if evals is not None:
            info.update(evals=evals, evals_per_s=evals / info["seconds_without_checks"])
        info.update(extra)
        steps[name] = info
        print(f"search stage {name}: " + json.dumps(info))
        return res

    # 1. structure space: dense climb with basin-hopping restarts (registry settings)
    hc = step("hill_climb", lambda: hillclimb.climb_with_restarts(
        climb, np.random.default_rng(seed + 11), restarts=s.hill_climb_restarts,
        max_parents=s.max_parents, tie_stop=s.hill_climb_tie_stop), climb_exact)
    steps["hill_climb"].update(
        iterations=hc.iterations, converged=bool(hc.converged), restart_history=hc.history,
        host_reads_per_step=-(-3 * n * n // 4096))

    # 2. one family-delta climb from the empty graph: the family entry's
    # path, every launch held against its plain version
    delta = step("delta_hill_climb", lambda: delta_hill_climb(
        fam, n, max_iters=max(s.hill_climb_iters, 4 * n), chunk=DELTA_CHUNK,
        accept_batch=s.hill_climb_accept_batch), climb_exact)
    d_info = steps["delta_hill_climb"]
    check(abs(d_info["best_bic_exact"] - delta.best_score) <= 1.0,
          f"delta climb's internal score {delta.best_score} vs exact {d_info['best_bic_exact']}")
    d_info.update(iterations=delta.iterations, converged=bool(delta.converged),
                  profile=delta.profile, dense_best_bic_exact=steps["hill_climb"]["best_bic_exact"])

    # host glue: encoded test-corpus seeds, their scores in chunks of 256, the PCA subspace
    t0 = time.perf_counter()
    seed_n = min(2048, len(test_c))
    lab_d = torch.as_tensor(test_c.labels[:seed_n], device="cuda")
    adj_d = torch.as_tensor(test_c.dense_batch(np.arange(seed_n)), device="cuda")
    mus = latent.encode_mu(model, lab_d, adj_d).cpu().numpy()
    seed_cols = relabel_to_columns(lab_d, adj_d)
    seed_scores = np.concatenate([scorer.score(seed_cols[i:i + 256]).cpu().numpy()
                                  for i in range(0, seed_n, 256)])
    elite_pick = np.argsort(-seed_scores)[: s.islands]
    k_sub = int(min(s.island_subspace, mus.shape[1], len(mus) - 1))
    z_center = mus.mean(axis=0)
    z_basis = np.linalg.svd(mus - z_center, full_matrices=False)[2][:k_sub]
    coords = (mus - z_center) @ z_basis.T
    sigma_vec = coords.std(axis=0) + 1e-6
    cem_space = dict(basis=z_basis, center=z_center, init_sigma=sigma_vec,
                     sigma_floor=sigma_vec * 0.05)
    hc_labels, hc_adj = latent.column_adj_to_labeled(hc.best_adj, np.random.default_rng(seed + 7))
    hc_mu = latent.encode_mu(model, torch.as_tensor(hc_labels[None], device="cuda"),
                             torch.as_tensor(hc_adj[None], device="cuda")).cpu().numpy()
    torch.cuda.synchronize()
    glue_s = time.perf_counter() - t0
    print(f"search stage seeds: {seed_n} test graphs encoded and scored, PCA subspace {k_sub}, "
          f"best seed {float(seed_scores.max()):.2f}, {glue_s:.2f} s")

    # 3-4. island CEM in the subspace (its first population kept for the
    # fused entry's check below), then the polish climb from its winner
    island_pop = []
    score = scorer.score

    def keep_first(adj):
        if not island_pop:
            island_pop.append(scorer._adj(adj).clone())
        return score(adj)

    scorer.score = keep_first
    try:
        res = step("island_cem", lambda: islands.island_cem_search(
            model, scorer, seed=seed + 2, num_islands=s.islands, population=s.island_population,
            iters=ISLAND_ITERS, init_means=coords[elite_pick], device="cuda", **cem_space),
            latent_exact, subspace=k_sub)
    finally:
        del scorer.score
    step("island_cem_polished", lambda: climb(init_adj=to_columns(res.best_labels, res.best_adj)),
         climb_exact)

    # 5. refine around the climb's winner under 8 random topological orders
    order_rng = np.random.default_rng(seed + 5)
    pairs = [latent.column_adj_to_labeled(hc.best_adj, order_rng) for _ in range(8)]
    step("latent_refined", lambda: latent.refine_search(
        model, scorer, np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
        seed=seed + 3, iters=REFINE_ITERS, population=s.refine_population, device="cuda"),
        latent_exact)

    # 6. predictor dataset of the test corpus, then the exact GP on it
    def fit_surrogate():
        vectors, targets = build_predictor_dataset(
            model, scorer, test_c.labels, test_c.dense_batch(np.arange(len(test_c))),
            batch_size=1024)
        keep = np.isfinite(targets)
        vectors, targets = vectors[keep], targets[keep]
        t_fit = time.perf_counter()
        gp = ExactGP(device="cuda").fit(vectors[:3000], targets[:3000], iters=s.gp_iters)
        torch.cuda.synchronize()
        return vectors, targets, gp, time.perf_counter() - t_fit

    vectors, targets, gp, fit_s = step("gp_fit", fit_surrogate)
    params = [float(p) for p in gp.params]
    check(np.isfinite(gp.final_nmll) and np.all(np.isfinite(params)),
          f"GP fit not finite: nmll {gp.final_nmll}, params {params}")
    pred = gp.predict(vectors[:256])
    check(np.all(np.isfinite(pred)), "GP predictions are not finite")
    steps["gp_fit"].update(points=int(min(len(vectors), 3000)), fit_s=fit_s,
                           fit_steps_per_s=s.gp_iters / fit_s, final_nmll=gp.final_nmll,
                           params=params, train_mae=float(np.abs(pred - targets[:256]).mean()))
    order = np.argsort(-targets)

    # 7-8. GP-UCB ascent from the strongest known latents, then closed-loop BO
    extra = [hc_mu] + ([res.best_z[None]] if np.isfinite(res.best_score) else [])
    z_init = np.concatenate(extra + [vectors[order[: s.gp_ascent_seeds - 2]]])[: s.gp_ascent_seeds]
    step("gp_ascent", lambda: latent.gp_ascent_search(
        model, scorer, gp, seed + 4, z_init, steps=100, ucb_beta=0.5,
        decode_rounds=s.gp_ascent_rounds, device="cuda"), latent_exact)
    bo = step("bo", lambda: latent.bo_search(
        model, scorer, seed + 6, z_init, extra_obs=(vectors[:3000], targets[:3000]),
        rounds=s.bo_rounds, ucb_beta=1.0, gp_iters=min(s.gp_iters, 200), acq_pool=4096,
        device="cuda"), latent_exact)
    check(bo.best_score >= bo.history[0], "BO fell below its seeds' decode")
    check(bo.num_evals == len(z_init) * (s.bo_rounds + 1), f"BO evals {bo.num_evals}")

    # 9. the same small budget of real evals for each latent strategy
    budget = s.budget_compare_evals
    s_n = max(budget // 4, 8)
    cold_seed = vectors[order[:s_n]]
    n_isl = min(4, s.islands)
    pop = max(s_n // n_isl, 8)
    it_cem = max((budget - s_n) // (n_isl * pop), 1)
    comp = {
        "budget_gp_ascent": step("budget_gp_ascent", lambda: latent.gp_ascent_search(
            model, scorer, gp, seed + 8, cold_seed, steps=100, ucb_beta=0.5,
            decode_rounds=budget // s_n - 1, device="cuda"), latent_exact),
        "budget_bo": step("budget_bo", lambda: latent.bo_search(
            model, scorer, seed + 9, cold_seed, extra_obs=(vectors[:3000], targets[:3000]),
            rounds=budget // s_n - 1, ucb_beta=1.0, gp_iters=min(s.gp_iters, 200),
            acq_pool=4096, device="cuda"), latent_exact),
        "budget_island_cem": step("budget_island_cem", lambda: islands.island_cem_search(
            model, scorer, seed=seed + 10, num_islands=n_isl, population=pop, iters=it_cem,
            init_means=coords[elite_pick[:n_isl]],
            exploit_repeats=max((budget - n_isl * pop * it_cem) // n_isl, 0), device="cuda",
            **cem_space), latent_exact),
    }
    for name, r in comp.items():
        check(r.num_evals <= budget, f"{name} spent {r.num_evals} evals, budget {budget}")
    winner = max(comp, key=lambda k: steps[k]["best_bic_exact"])

    for name, info in steps.items():
        # the delta climb counts families; the predictor's targets are
        # float64 exact scores, whose counts the fused entry makes; every
        # other step scores through the score entry
        entry = {"delta_hill_climb": "contingency_counts_family",
                 "gp_fit": "contingency_counts_fused"}.get(name, "node_scores_fused")
        launches = info["launches"]
        check(launches[entry] > 0 and bic_launches(launches) == launches[entry],
              f"{name}: launches {launches}")
        if name in LATENT_STEPS:
            check_decodes(launches, model, name)

    # the fused and the score entry at the inputs these paths send them: a
    # dense-climb chunk (the first window of 4,096 moves, hill_climb's
    # default, from the climb's best graph) and the island CEM's first
    # population of 8 x 512
    moves = hillclimb._move_candidates(torch.as_tensor(hc.best_adj, device="cuda"))
    fused_stage = {
        "climb_chunk": hold_fused(torch, scorer, moves[:4096], "dense climb chunk"),
        "island_population": hold_fused(torch, scorer, island_pop[0], "island CEM population"),
    }
    score_stage = {
        "climb_chunk": time_score_entry(torch, scorer, moves[:4096], "dense climb chunk",
                                        chunk=ALARM_HOLD_CANDIDATES),
        "island_population": time_score_entry(torch, scorer, island_pop[0],
                                              "island CEM population",
                                              chunk=ALARM_HOLD_CANDIDATES),
    }
    del moves, island_pop
    return {"steps": steps, "seeds_s": glue_s, "budget_winner": winner,
            "cuts": {"island_iters": [s.island_iters, ISLAND_ITERS],
                     "refine_iters": [s.refine_iters, REFINE_ITERS]},
            "fused_stage": fused_stage, "score_stage": score_stage,
            "family_seg": time_family_seg(torch, fam, delta.best_adj)}


def phase_wide_rows(torch, alarm_scorer) -> dict:
    """Phase 11: rows of S = 65,536 bins at barley width through both
    entries' wide kernels; checks in the module docstring."""
    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
    from dags_vae_search_tpu_torch.ops import bic_kernel
    from dags_vae_search_tpu_torch.scoring.bic import BicScorer
    from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
    from dags_vae_search_tpu_torch.search import hillclimb
    from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb

    cfg = REGISTRY[WIDE_NAME]
    s, n = cfg.search, cfg.num_vertices
    _, dataset = make_synthetic_problem(WIDE_NAME, num_cases=cfg.simulate_cases,
                                        max_card=WIDE_MAX_CARD, seed=cfg.seed)
    scorer = BicScorer(dataset, max_parents=s.max_parents, device="cuda")
    fam = FamilyBatchScorer(dataset, max_parents=s.max_parents, q_cap=scorer.q_cap, device="cuda")
    S = scorer.q_cap * scorer.r_max
    print(f"wide rows ({WIDE_NAME}, n={n}, {dataset.num_cases} cases, cards up to "
          f"{WIDE_MAX_CARD}): r_max={scorer.r_max}, U={scorer.num_unique_rows}, "
          f"q_cap={scorer.q_cap}, S={S}")
    check(S == 65_536 and bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, n))
          == bic_kernel.route("family", S, bic_kernel.family_block_bytes(S, s.max_parents + 1))
          == "wide", f"S={S} does not take the wide route")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps: dict = {}

    def step(name, fn, chunk=TIER_HOLD_CANDIDATES):
        torch.cuda.synchronize()
        reset_launches()
        with held_launches(torch, chunk) as held:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        steps[name] = {"seconds": seconds, "launches": read_launches(),
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "held": held, "seconds_without_checks": seconds - held["check_s"]}
        check_held(steps[name]["launches"], held, name)
        return res

    def dense_climb(steps_):
        return hillclimb.hill_climb(scorer, n, max_iters=steps_, score_chunk=WIDE_CLIMB_CHUNK)

    dense = step("dense_climb", lambda: dense_climb(WIDE_CLIMB_STEPS), WIDE_HOLD_CANDIDATES)
    delta = step("delta_climb", lambda: delta_hill_climb(
        fam, n, max_iters=max(s.hill_climb_iters, 4 * n), chunk=DELTA_CHUNK,
        accept_batch=s.hill_climb_accept_batch))
    for name, res, entry in (("dense_climb", dense, "node_scores_fused_wide"),
                             ("delta_climb", delta, "contingency_counts_family_wide")):
        info = steps[name]
        launches = info["launches"]
        check(launches[entry] > 0 and bic_launches(launches) == launches[entry],
              f"wide {name}: launches {launches}")
        check(all(b >= a for a, b in zip(res.history, res.history[1:])), f"{name} history decreased")
        info.update(best_bic=res.best_score, best_bic_exact=check_exact(scorer, res.best_score,
                                                                         res.best_adj),
                    iterations=res.iterations, converged=bool(res.converged),
                    evals=res.num_evals,
                    evals_per_s=res.num_evals / info["seconds_without_checks"],
                    edges=int(np.asarray(res.best_adj).sum()))
        print(f"wide {name}: " + json.dumps(info))
    # the kernels at the inputs these paths send them
    moves = hillclimb._move_candidates(torch.as_tensor(dense.best_adj, device="cuda"))
    fused = hold_fused(torch, scorer, moves[:WIDE_CLIMB_CHUNK], "wide dense climb chunk")
    seg = time_family_seg(torch, fam, delta.best_adj)
    peak = max([torch.cuda.max_memory_allocated() / 2**30]
               + [v["peak_mem_gib"] for v in steps.values()])
    check(peak < WIDE_PEAK_GIB, f"phase 11 peak {peak:.2f} GiB")
    # (its own peaks, above what the phase holds)
    score = time_score_entry(torch, scorer, moves[:WIDE_CLIMB_CHUNK], "wide dense climb chunk",
                             chunk=TIER_HOLD_CANDIDATES)
    del moves

    # rows of 512 bins still take the narrow kernels
    reset_launches()
    alarm_n = alarm_scorer.dataset.num_variables
    alarm_scorer.score(torch.zeros((4, alarm_n, alarm_n), device="cuda"))
    torch.cuda.synchronize()
    narrow = read_launches()
    check(narrow["node_scores_fused"] == 1 and sum(narrow.values()) == 1,
          f"rows of {alarm_scorer.q_cap * alarm_scorer.r_max} bins: launches {narrow}")
    out = {"dataset": {"name": WIDE_NAME, "n": n, "cases": dataset.num_cases,
                       "r_max": scorer.r_max, "U": scorer.num_unique_rows, "q_cap": scorer.q_cap,
                       "S": S},
           "cuts": {"dense_climb_steps": [s.hill_climb_iters, WIDE_CLIMB_STEPS],
                    "score_chunk": [4096, WIDE_CLIMB_CHUNK]},
           "steps": steps, "fused_climb_chunk": fused, "score_climb_chunk": score,
           "family_seg": seg, "peak_mem_gib": peak,
           "narrow_check_launches": narrow}
    return out


def _dp_fit(model_kwargs: dict, train_cfg, corpus, mesh=None, record=False, forced=None) -> dict:
    """Phase 13: ``Trainer.fit`` from seed ``SEED`` on ``corpus``, one epoch,
    on one process (``mesh`` None, the card) or as one rank of ``mesh``.

    ``record`` keeps, for every step, the parameters it starts from and the
    summed gradients it computes (before the clip), on the host.
    ``forced``, another run's record, sets the parameters to that run's
    before each step (after recording them), so each step of this run starts
    from the state the other run's step started from."""
    import torch

    from dags_vae_search_tpu_torch.models.pace_vae import make_model
    from dags_vae_search_tpu_torch.training.train import Trainer

    dev = torch.device("cuda") if mesh is None else mesh.device
    trainer = Trainer(make_model(SEED, dev, **model_kwargs), train_cfg, mesh=mesh)
    state = trainer.init_state(SEED)
    steps: dict = {"before": [], "grads": []}
    if record:
        compute = trainer.compute_gradients

        def recording_compute(state, labels, adj, generator=None):
            params = dict(state.model.named_parameters())
            steps["before"].append({k: p.detach().to("cpu", copy=True) for k, p in params.items()})
            if forced is not None:
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(forced["before"][len(steps["grads"])][k])
            losses = compute(state, labels, adj, generator)
            steps["grads"].append({k: p.grad.detach().to("cpu", copy=True)
                                   for k, p in params.items()})
            return losses

        trainer.compute_gradients = recording_compute
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, hist = trainer.fit(state, corpus, log=lambda line: None)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"losses": [hist[-1][k] for k in ("loss_per_graph", "recon_per_graph", "kld_per_graph")],
            **steps, "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "steps": state.step, "step_ms": 1e3 * seconds / state.step}


def _dp_islands(model_kwargs: dict, codes, cards, max_parents: int, mesh=None) -> dict:
    """Phase 13 (c): island CEM in mode decode, on one process or a rank."""
    import torch

    from dags_vae_search_tpu_torch.models.pace_vae import make_model
    from dags_vae_search_tpu_torch.scoring.bic import BicScorer
    from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
    from dags_vae_search_tpu_torch.search.islands import island_cem_search

    dev = torch.device("cuda") if mesh is None else mesh.device
    scorer = BicScorer(DiscreteDataset(codes, cards, [f"x{i}" for i in range(codes.shape[1])]),
                       max_parents=max_parents, device=dev)
    model = make_model(SEED, dev, **model_kwargs)
    torch.cuda.synchronize(dev)
    reset_launches(trace_decodes=True)
    t0 = time.perf_counter()
    res = island_cem_search(model, scorer, seed=SEED,
                            num_islands=DP_ISLANDS, population=DP_POPULATION, iters=DP_ITERS,
                            temperature_range=(1e-3, 1e-3), device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {**res._asdict(), "seconds": seconds,
            "decode_launches": read_launches()["decode_attention"],
            "decode_calls": decode_calls(model)}


def _dp_rank(mesh, model_kwargs, train_cfg, corpus, codes, cards, max_parents) -> dict:
    """Phase 13 (b) and (c) on one rank of the two-rank group."""
    return {"rank": mesh.rank, "world": mesh.world_size, "device": str(mesh.device),
            "fit": _dp_fit(model_kwargs, train_cfg, corpus, mesh, record=mesh.rank == 0),
            "islands": _dp_islands(model_kwargs, codes, cards, max_parents, mesh)}


def phase_data_parallel(torch, cfg, train_c, dataset) -> dict:
    """Phase 13: ``Trainer(mesh=...)`` and ``island_cem_search(mesh=...)`` at
    alarm width on the one card; checks in the module docstring."""
    import torch.distributed as dist

    from dags_vae_search_tpu_torch.parallel import mesh as mesh_lib

    b = cfg.train.batch_size
    train_cfg = dataclasses.replace(cfg.train, epochs=1, log_every=0)
    out: dict = {}

    # (a) a world of one on NCCL, the registry's dropout and noise on
    cut = train_c.take(np.arange(4 * b))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            mesh = mesh_lib.make_mesh(device="cuda:0")
            alone = _dp_fit(cfg.model_kwargs(), train_cfg, cut)
            one = _dp_fit(cfg.model_kwargs(), train_cfg, cut, mesh)
        finally:
            dist.destroy_process_group()
    check(one["steps"] == alone["steps"] == 4, f"steps {one['steps']}, {alone['steps']}")
    check(one["losses"] == alone["losses"] and all(
        torch.equal(one["params"][k], alone["params"][k]) for k in alone["params"]),
        "a world-size-1 NCCL mesh is not bit-identical to mesh=None")
    out["world_of_one"] = {"steps": 4, "bit_identical": True, "losses": one["losses"],
                           "step_ms": {"mesh": one["step_ms"], "none": alone["step_ms"]},
                           "seconds": time.perf_counter() - t0}
    print("data parallel (a): NCCL world of one, 4 chunked steps bit-identical to mesh=None; "
          + json.dumps(out["world_of_one"]))
    del alone, one

    # (b) two gloo ranks sharing the card, dropout 0, the same noise; (c) islands
    kwargs = dict(cfg.model_kwargs(), dropout=0.0)
    corpus = train_c.take(np.arange(DP_STEPS * b))
    codes, cards = np.asarray(dataset.codes), np.asarray(dataset.cards)
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(_dp_rank, 2, kwargs, train_cfg, corpus, codes, cards,
                           cfg.search.max_parents, device="cuda:0", backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    # one process, each step started from the two-rank run's state (rank 0's)
    ranked = ranks[0]["fit"]
    single = _dp_fit(kwargs, train_cfg, corpus, record=True, forced=ranked)
    check(single["steps"] == DP_STEPS == len(ranked["grads"]), f"{single['steps']} steps")
    check(all(torch.equal(ranked["params"][k], ranks[1]["fit"]["params"][k])
              for k in ranked["params"]), "the two ranks hold different parameters")
    # Each step's summed gradients, over all parameters, are held to a
    # norm-wise relative difference of 1e-4.  Element by element they differ
    # by rounding: each sums up to 128 x 39 x 39 terms of both signs, split
    # over two ranks and multiplied by other cuBLAS kernels, so where the
    # terms cancel, the sum keeps little of its value.  Each step's result,
    # from the same start, is held to rtol 1e-4 / atol 1e-5 at the elements
    # whose two gradients agreed within DP_GRAD_RTOL of the one-process one
    # at every step so far: Adam's update moves by about 1.4 dg/|g| per step
    # at most, so those stay within 5 x 1.4 x 1e-3 of a step of lr 2e-4,
    # below 1.4e-6.  The others are left out and counted.
    unsettled = {name: torch.zeros_like(g, dtype=torch.bool)
                 for name, g in single["grads"][0].items()}
    total = sum(g.numel() for g in unsettled.values())
    worst = {"loss": float(np.abs(np.subtract(ranked["losses"], single["losses"])).max()),
             "param_kept": 0.0, "param_left_out": 0.0, "grad_rel_norm": [], "left_out": [],
             "outside_tolerance": [], "outside_tolerance_kept": []}
    check(np.allclose(ranked["losses"], single["losses"], rtol=1e-4, atol=1e-5),
          f"losses {ranked['losses']} vs one process {single['losses']}")
    for t in range(DP_STEPS):
        after = {run: (r["before"][t + 1] if t + 1 < DP_STEPS else r["params"])
                 for run, r in (("ranks", ranked), ("single", single))}
        sq_diff = sq_want = 0.0
        outside = outside_kept = 0
        for name, want in single["grads"][t].items():
            grad_diff = (ranked["grads"][t][name] - want).abs()
            sq_diff += float(grad_diff.double().square().sum())
            sq_want += float(want.double().square().sum())
            unsettled[name] |= grad_diff > DP_GRAD_RTOL * want.abs()
            kept = ~unsettled[name]
            value = after["ranks"][name]
            diff = (after["single"][name] - value).abs()
            out_tol = diff > 1e-5 + 1e-4 * value.abs()
            outside += int(out_tol.sum())
            outside_kept += int((out_tol & kept).sum())
            for key, where in (("param_kept", kept), ("param_left_out", ~kept)):
                if where.any():
                    worst[key] = max(worst[key], float(diff[where].max()))
        worst["grad_rel_norm"].append((sq_diff / sq_want) ** 0.5)
        worst["left_out"].append(sum(int(m.sum()) for m in unsettled.values()))
        worst["outside_tolerance"].append(outside)
        worst["outside_tolerance_kept"].append(outside_kept)
    print(f"data parallel (b), per step of {DP_STEPS} over {total} parameter elements: "
          + json.dumps(worst))
    check(max(worst["grad_rel_norm"]) <= 1e-4,
          f"summed gradients differ from one process by {worst['grad_rel_norm']} (norm-wise)")
    check(sum(worst["outside_tolerance_kept"]) == 0,
          f"parameter elements with settled gradients differ from one process past rtol 1e-4 / "
          f"atol 1e-5 at steps 1-{DP_STEPS}: {worst['outside_tolerance_kept']} (largest "
          f"{worst['param_kept']})")
    out["two_ranks_sharing_one_card"] = {
        "steps": DP_STEPS, "batch": b, "losses": ranks[0]["fit"]["losses"],
        "one_process_losses": single["losses"], "max_diff": worst, "parameters": total,
        "step_ms_two_ranks_sharing_one_card_with_records": [r["fit"]["step_ms"] for r in ranks],
        "step_ms_one_process_with_records": single["step_ms"], "spawn_s": spawn_s}
    print(f"data parallel (b): 2 gloo ranks sharing one card vs one process, {DP_STEPS} steps, "
          "each from the same start; "
          + json.dumps(out["two_ranks_sharing_one_card"]))

    alone = _dp_islands(kwargs, codes, cards, cfg.search.max_parents)
    check(np.isfinite(alone["best_score"]), f"island best {alone['best_score']}")
    for r in ranks:
        got = r["islands"]
        check(got["best_score"] == alone["best_score"] and got["history"] == alone["history"]
              and np.array_equal(got["best_adj"], alone["best_adj"])
              and np.array_equal(got["best_labels"], alone["best_labels"]),
              f"rank {r['rank']}: islands best {got['best_score']} vs one process "
              f"{alone['best_score']}")
        check(got["num_evals"] == DP_ISLANDS * DP_POPULATION * DP_ITERS + DP_ISLANDS * 32,
              f"island evals {got['num_evals']}")
    for got in [alone, *(rank["islands"] for rank in ranks)]:
        check(got["decode_launches"] > 0 and got["decode_launches"] % got["decode_calls"] == 0,
              f"island CEM: {got['decode_launches']} decode-attention launches, want whole "
              f"decodes of {got['decode_calls']}")
    out["islands_two_ranks"] = {
        "islands": DP_ISLANDS, "population": DP_POPULATION, "iters": DP_ITERS,
        "best_bic": alone["best_score"], "history": alone["history"],
        "evals": alone["num_evals"], "seconds_two_ranks_sharing_one_card":
        [r["islands"]["seconds"] for r in ranks], "seconds_one_process": alone["seconds"]}
    print("data parallel (c): island CEM over 2 ranks sharing one card equals one process; "
          + json.dumps(out["islands_two_ranks"]))
    return out


def _skipped(tree, path="") -> list:
    """Paths of the ``"skipped (...)"`` strings in a report tree."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _skipped(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _skipped(v, f"{path}/{i}")]
    return [path] if isinstance(tree, str) and tree.startswith("skipped (") else []


def phase_native_codec() -> dict:
    """Phase 12: the native codec at link width.  ``LINK_GRAPHS`` random DAGs
    with n = 724 (about 2n edges each) written in two npz parts, read back
    through the codec ``LINK_REPS`` times, then each part's loaded columns
    decoded by the library and by numpy in ``LINK_PAIRS`` pairs on the host
    clock, the order alternating from pair to pair: all bit-equal.  Also the
    first and the second fill of a fresh array of one part's output size, the
    share of a decode that is the first touch of its output."""
    from dags_vae_search_tpu_torch import native
    from dags_vae_search_tpu_torch.graphs import codec

    lib = native.load()
    check(lib is not None, f"the native codec did not build: {native.build_log}")
    rng = np.random.default_rng(SEED)
    n = LINK_N
    labels = np.stack([rng.permutation(n) for _ in range(LINK_GRAPHS)]).astype(np.int32)
    adj = np.triu(rng.random((LINK_GRAPHS, n, n), dtype=np.float32) < 4.0 / n, 1).astype(np.float32)
    times = {"native": [], "numpy": []}  # per part, per pair
    touch_ms = []
    with tempfile.TemporaryDirectory() as tmp:
        codec.write_dataset(tmp, labels, adj, rows_per_part=LINK_GRAPHS // 2)
        parts = codec.dataset_parts(tmp)
        read_s = []
        for _ in range(LINK_REPS):
            t0 = time.perf_counter()
            got = codec.read_dataset(tmp)
            read_s.append(time.perf_counter() - t0)
        check(np.array_equal(got[0], labels) and np.array_equal(got[1], adj),
              "link-width npz corpus read back differs")
        start = 0
        for part in parts:
            with np.load(part) as blob:
                bits = {i: blob[f"e{i}"] for i in range(1, n)}
            rows = bits[1].shape[0]
            decode = {"native": lambda: native.decode_edges(bits, n, rows, lib),
                      "numpy": lambda: codec.decode_edges_numpy(bits, n, rows)}
            decoded, part_times = {}, {"native": [], "numpy": []}
            for pair in range(LINK_PAIRS):
                for name in (("native", "numpy") if pair % 2 == 0 else ("numpy", "native")):
                    t0 = time.perf_counter()
                    decoded[name] = decode[name]()
                    part_times[name].append(time.perf_counter() - t0)
            for name in times:
                times[name].append(part_times[name])
            check(np.array_equal(decoded["native"], decoded["numpy"]),
                  f"{part}: native decode differs from numpy's")
            check(np.array_equal(decoded["native"], adj[start:start + rows]),
                  f"{part}: native decode differs from the written graphs")
            start += rows
            del decoded
            fresh = np.empty((rows, n, n), dtype=np.float32)
            fills = []
            for _ in range(2):
                t0 = time.perf_counter()
                fresh.fill(0.0)
                fills.append(1e3 * (time.perf_counter() - t0))
            touch_ms.append(fills)
            del fresh
    speedups = [b / a for nat, num in zip(times["native"], times["numpy"]) for a, b in zip(nat, num)]
    median_s = {name: [float(np.median(t)) for t in times[name]] for name in times}
    out = {"n": n, "graphs": LINK_GRAPHS, "parts": len(parts), "pairs_per_part": LINK_PAIRS,
           "edges_per_graph": float(adj.sum()) / LINK_GRAPHS, "read_s": read_s,
           "decode_s_per_part_per_pair": times,
           "native_graphs_per_s": LINK_GRAPHS / sum(median_s["native"]),
           "numpy_graphs_per_s": LINK_GRAPHS / sum(median_s["numpy"]),
           "median_pair_speedup": float(np.median(speedups)),
           "pairs_native_ahead": sum(x > 1.0 for x in speedups), "pairs": len(speedups),
           "fresh_output_fill_ms_first_second": touch_ms}
    print("native codec at link width (host): native and numpy decodes bit-equal; "
          + json.dumps(out))
    return out


@contextlib.contextmanager
def kept_results(*targets):
    """Inside the block, each ``(module, name)`` function keeps what it
    returns in a list, by name (a class keeps its instances)."""
    kept = {name: [] for _, name in targets}
    saved = [(module, name, getattr(module, name)) for module, name in targets]
    for module, name, real in saved:
        def keeper(*args, _real=real, _name=name, **kwargs):
            kept[_name].append(_real(*args, **kwargs))
            return kept[_name][-1]

        setattr(module, name, keeper)
    try:
        yield kept
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def phase_pipeline(torch, cfg, name: str, corpus, train_c, test_c, hc_best: float) -> dict:
    """Phase 10: the port's ``ExperimentRunner`` through every stage on the
    card, its CLI in a subprocess, the results page; checks in the module
    docstring.  ``corpus``, ``train_c`` and ``test_c`` are phase 5's,
    ``hc_best`` is phase 9's dense climb best (float64)."""
    from dags_vae_search_tpu_torch.experiments import results
    from dags_vae_search_tpu_torch.experiments.runner import ExperimentRunner
    from dags_vae_search_tpu_torch.graphs import codec
    from dags_vae_search_tpu_torch.search import hillclimb
    from dags_vae_search_tpu_torch.training import data

    cfg = copy.deepcopy(cfg)
    cfg.corpus.batch_size = CORPUS_BATCH
    cfg.search.island_iters, cfg.search.refine_iters = ISLAND_ITERS, REFINE_ITERS
    # the registry checkpoints every 5 epochs; the cut run ends on one
    cfg.train.checkpoint_every = TRAIN_EPOCHS
    stages: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = os.path.join(tmp, "runs")
        runner = ExperimentRunner(cfg, data_dir=runs, device="cuda")
        check(runner.reports_root == os.path.join(tmp, "reports_torch", cfg.name),
              f"reports mirror at {runner.reports_root}")

        def run(stage, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            stages[stage] = {"seconds": time.perf_counter() - t0,
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "launches": read_launches()}

        run("generate", runner.stage_generate)
        labels, adj = codec.read_dataset(runner.path("corpus"))
        check(np.array_equal(labels, corpus.labels) and np.array_equal(adj, corpus.adj),
              "the npz corpus read back differs from the generated tensors")
        run("split", runner.stage_split)
        for split, want in (("train", train_c), ("test", test_c)):
            got = data.load_corpus(runner.path(split))
            check(np.array_equal(got.labels, want.labels) and np.array_equal(got.adj, want.adj),
                  f"the npz {split} split differs from phase 5's")
        run("train", lambda: runner.stage_train(epochs=TRAIN_EPOCHS))
        run("eval", lambda: runner.stage_eval(use_isomorphism=False))
        run("predictor", runner.stage_predictor)
        run("gp", runner.stage_gp)
        # keep the structure the dense climb returns, for its host re-score
        with kept_results((hillclimb, "climb_with_restarts")) as kept:
            run("search", runner.stage_search)
        climbs = kept["climb_with_restarts"]
        run("roundtrip", runner.stage_roundtrip)

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dags_vae_search_tpu_torch.experiments.runner", cfg.name, "gp",
             "roundtrip", "--data-dir", runs],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"the runner CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        page_path = os.path.join(tmp, "RESULTS_torch.md")
        with contextlib.redirect_stdout(io.StringIO()):
            results.main([runs, page_path])
        with open(page_path) as fh:
            page = fh.read()

        reports = {}
        for stage in PIPELINE_STAGES:
            for root in (runner.root, runner.reports_root):
                path = os.path.join(root, f"report_{stage}.json")
                check(os.path.isfile(path), f"missing {path}")
            with open(os.path.join(runner.root, f"report_{stage}.json")) as fh:
                reports[stage] = json.load(fh)
        host_scorer = runner.scorer()
    skipped = _skipped(reports)
    check(not skipped, f"skipped report entries: {skipped}")
    search = reports["search"]
    hc_bic = search["hill_climb"]["best_bic"]
    check(len(climbs) == 1, f"{len(climbs)} dense climbs in the search stage")
    host = float(host_scorer.score_exact_sparse(climbs[0].best_adj[None])[0])
    check(np.isfinite(hc_bic) and abs(hc_bic - host) <= 1e-9 * abs(host),
          f"climb best {hc_bic} vs host re-score {host}")
    check(abs(hc_bic - hc_best) <= 1e-9 * abs(hc_best), f"climb best {hc_bic} vs phase 9's {hc_best}")
    latent = {k: search[k]["best_bic_exact"] for k in ("island_cem", "latent_refined", "gp_ascent", "bo")}
    latent.update({f"budget_{k}": search["budget_comparison"][k]["best_bic_exact"]
                   for k in ("gp_ascent", "bo", "island_cem")})
    check(all(v is not None and np.isfinite(v) for v in latent.values()), f"latent bests {latent}")
    check(np.isfinite(reports["eval"]["valid_ratio_mode"]), "valid_ratio_mode is not finite")
    check(np.isfinite(reports["gp"]["mape"]), "GP mape is not finite")
    # the search scores through the score entry (and re-scores its bests
    # in float64 through the fused entry's counts); the predictor's targets
    # are float64 exact scores
    check(stages["search"]["launches"]["node_scores_fused"] > 0
          and stages["search"]["launches"]["contingency_counts_fused"] > 0,
          f"search: launches {stages['search']['launches']}")
    check(stages["search"]["launches"]["decode_attention"] > 0,
          f"search: launches {stages['search']['launches']}")
    check(stages["predictor"]["launches"]["contingency_counts_fused"] > 0,
          "predictor: no fused launch")
    check(name in page, "the results page does not name the card")
    check(all(r["device"].startswith(name) for r in reports.values()), "a report names another device")

    record = {
        "stages": stages,
        "cli_gp_roundtrip_s": cli_s,
        "cuts": {"corpus_batch": [64, CORPUS_BATCH], "epochs": [120, TRAIN_EPOCHS],
                 "checkpoint_every": [5, TRAIN_EPOCHS],
                 "island_iters": [30, ISLAND_ITERS], "refine_iters": [15, REFINE_ITERS]},
        "device": reports["search"]["device"],
        "rows": {"corpus": reports["generate"]["rows"], "train": reports["split"]["train_rows"],
                 "test": reports["split"]["test_rows"]},
        "train_final": reports["train"]["final"],
        "eval": {k: v for k, v in reports["eval"].items() if k not in ("stage", "time", "device")},
        "gp": {k: reports["gp"][k] for k in ("model", "train_points", "mae", "mape")},
        "hill_climb": {"best_bic": hc_bic, "host_rescore": host, "phase9": hc_best,
                       "evals_per_sec": search["hill_climb"]["evals_per_sec"]},
        "latent_bests_exact": latent,
        "budget_winner": search["budget_comparison"].get("winner"),
        "roundtrip": {k: reports["roundtrip"][k] for k in
                      ("true_bic", "gp_predicted_bic", "relative_error", "decode_valid")},
        "results_header": page.splitlines()[0],
    }
    summary = {s: {"wall_s": round(v["seconds"], 3), "peak_gib": round(v["peak_mem_gib"], 3),
                   "score": v["launches"]["node_scores_fused"],
                   "fused": v["launches"]["contingency_counts_fused"],
                   "family": v["launches"]["contingency_counts_family"]}
               for s, v in stages.items()}
    print(f"pipeline stages ({nvidia_smi('name,power.limit')}): " + json.dumps(summary)
          + f"; CLI gp roundtrip {cli_s:.2f} s")
    return record


@contextlib.contextmanager
def held_launches(torch, chunk=TIER_HOLD_CANDIDATES):
    """Inside the block, every launch of the score, the fused, the seg and
    the family entry (on either route) is held against its plain version on
    the same inputs: the counts bit for bit (tolerance 0), the scores within
    ``SCORE_RTOL`` / ``SCORE_ATOL``; the score and fused entries' plain
    versions run on ``chunk`` candidates at a time.  Yields a record of the
    calls held per entry, the scores' largest difference and the seconds
    the comparisons took (kept out of the rates).  An entry counts its
    launches on the function its module name holds, so each checking
    wrapper carries the count while it is installed and hands it back."""
    from dags_vae_search_tpu_torch.ops import bic_kernel

    names = {"score": "node_scores_fused", "fused": "contingency_counts_fused",
             "seg": "contingency_counts_kernel", "family": "contingency_counts_family"}
    entries = {key: getattr(bic_kernel, name) for key, name in names.items()}
    held = {"score": 0, "fused": 0, "seg": 0, "family": 0, "score_err": 0.0, "check_s": 0.0,
            "family_clusters": {}}

    def check_score_plain(out, args, kwargs):
        want = score_plain(torch, args, kwargs, chunk)
        err = scores_err(torch, out[0], want, f"score launch {held['score']}")
        held["score_err"] = max(held["score_err"], err)

    def check_fused_plain(out, args, kwargs):
        check_fused(torch, out, args, f"fused launch {held['fused']}", chunk)

    def check_seg_plain(out, args, kwargs):
        check(torch.equal(out, bic_kernel.contingency_counts_plain(*args)),
              f"seg launch {held['seg']} differs from the plain version")

    def check_family_plain(out, args, kwargs):
        check(torch.equal(out, bic_kernel.contingency_counts_family_plain(*args)),
              f"family launch {held['family']} differs from the plain version")
        picked = str(picked_cluster(args))
        held["family_clusters"][picked] = held["family_clusters"].get(picked, 0) + 1

    checks = {"score": check_score_plain, "fused": check_fused_plain, "seg": check_seg_plain,
              "family": check_family_plain}

    def holding(key):
        def held_entry(*args, **kwargs):
            out = entries[key](*args, **kwargs)
            t0 = time.perf_counter()
            checks[key](out, args, kwargs)
            held[key] += 1
            held["check_s"] += time.perf_counter() - t0
            return out
        held_entry.launches = entries[key].launches
        return held_entry

    wrappers = {key: holding(key) for key in names}
    for key, name in names.items():
        setattr(bic_kernel, name, wrappers[key])
    try:
        yield held
    finally:
        for key, name in names.items():
            setattr(bic_kernel, name, entries[key])
            entries[key].launches = wrappers[key].launches


def check_held(launches: dict, held: dict, label: str) -> None:
    """Every call of an entry inside :func:`held_launches` launched once, on
    one of its two routes, and was held."""
    for key, name in (("score", "node_scores_fused"), ("fused", "contingency_counts_fused"),
                      ("seg", "contingency_counts"), ("family", "contingency_counts_family")):
        check(launches[name] + launches[f"{name}_wide"] == held[key],
              f"{label}: launches {launches}, held {held}")


def tier_train(torch, cfg, train_c, test_c, matmul_dtype, log_dir) -> tuple:
    """Phase 14's training under one operand type: the registry's
    ``Trainer`` from the seed, ``TIER_FIT_EPOCHS`` epochs of its chunked fit
    loop, then one timed chunk of ``steps_per_call`` steps on random batches
    of the resident corpus (as the JAX bench times it), then
    ``TIER_PROFILE_STEPS`` steps under ``utils.profiling.trace``.  The
    model's loss on ``TIER_EVAL_GRAPHS`` test graphs in eval mode is held
    against a CPU copy: rtol 1e-4 in float32 (sums in another order), 1e-3
    with bfloat16 operands (a sum in another order can move an operand by
    one bf16 step, 2^-8 relative)."""
    from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE, num_parameters
    from dags_vae_search_tpu_torch.training.train import Trainer

    dev = torch.device("cuda")
    label = matmul_dtype or "float32"
    kwargs = dict(cfg.model_kwargs(), matmul_dtype=matmul_dtype)
    trainer = Trainer(PaceVAE(**kwargs).to(dev), cfg.train)
    state = trainer.init_state(cfg.seed)
    params = num_parameters(state.model)
    check(cfg.name != TIER_NAME or params == TIER_PARAMS,
          f"{cfg.name} model has {params} parameters, want {TIER_PARAMS:,}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = trainer.fit(state, train_c, epochs=TIER_FIT_EPOCHS,
                              log=lambda line: print(f"  fit ({label}):", line))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    state, timed = time_chunk(torch, trainer, state, train_c, log_dir, TIER_PROFILE_STEPS)
    launches = read_launches()
    losses = np.asarray(timed["chunk_losses"])
    check(np.all(np.isfinite(losses)) and all(np.isfinite(h["loss_per_graph"]) for h in hist),
          f"{label}: non-finite training loss")
    check(sum(launches.values()) == 0, f"{label}: a kernel launched in training: {launches}")

    # eval-mode loss on a few test graphs, card vs a CPU copy
    model = state.model
    idx = np.arange(TIER_EVAL_GRAPHS)
    lab = torch.as_tensor(test_c.labels[idx])
    adj = torch.as_tensor(test_c.dense_batch(idx))
    model.eval()
    with torch.no_grad():
        card = torch.stack(model.loss(lab.to(dev), adj.to(dev))).cpu()
        cpu = torch.stack(copy.deepcopy(model).cpu().loss(lab, adj))
    model.train()
    rtol = 1e-4 if matmul_dtype is None else 1e-3
    check(torch.allclose(card, cpu, rtol=rtol, atol=1e-5),
          f"{label}: card loss {card.tolist()} vs CPU {cpu.tolist()} (rtol {rtol})")
    out = {"matmul_dtype": label, "params": params, "fit_epochs": len(hist), "fit_s": fit_s,
           "fit_history": hist, **timed,
           "loss_card_vs_cpu": {"card": card.tolist(), "cpu": cpu.tolist()}}
    print(f"link train ({label}): step {timed['step_ms']:.3f} ms over a chunk of "
          f"{timed['chunk_steps']} x {timed['batch']} graphs, device busy {busy_text(timed)}, "
          f"peak {timed['peak_mem_gib']:.3f} GiB, total losses of the chunk's steps "
          f"{losses[:, 0].tolist()}, card vs CPU loss {card.tolist()} / {cpu.tolist()}")
    return state, out


def phase_tier(torch, cfg) -> dict:
    """Phase 14: the registry's very-large tier end to end at its widths;
    checks in the module docstring."""
    from dags_vae_search_tpu_torch import native
    from dags_vae_search_tpu_torch.experiments.runner import ExperimentRunner
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
    from dags_vae_search_tpu_torch.search import islands
    from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb
    from dags_vae_search_tpu_torch.search.latent import _relabel_and_check, decode_and_score
    from dags_vae_search_tpu_torch.training import checkpoint, data
    from dags_vae_search_tpu_torch.training.eval import evaluate_corpus

    cuts = {"corpus_batch": [cfg.corpus.batch_size, TIER_CORPUS_BATCH],
            "fit_epochs": [cfg.train.epochs, TIER_FIT_EPOCHS],
            "island_iters": [cfg.search.island_iters, TIER_ISLAND_ITERS],
            "exploit_repeats": [32, TIER_EXPLOIT],
            "hill_climb_time_s": [cfg.search.hill_climb_time_s, TIER_CLIMB_S],
            "eval_graphs": TIER_EVAL_GRAPHS}
    cfg = dataclasses.replace(cfg, corpus=dataclasses.replace(cfg.corpus,
                                                              batch_size=TIER_CORPUS_BATCH))
    s, n = cfg.search, cfg.num_vertices
    out: dict = {"experiment": cfg.name, "n": n, "card": nvidia_smi("name,power.limit")}
    peaks = {}

    def peak_of(name):
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()

    with tempfile.TemporaryDirectory() as tmp:
        # 1. corpus: sampler -> codec (npz parts, native decode) -> load_corpus
        check(native.load() is not None, f"the native codec did not build: {native.build_log}")
        runner = ExperimentRunner(cfg, data_dir=os.path.join(tmp, "runs"), device="cuda")
        t0 = time.perf_counter()
        runner.stage_generate()
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner.stage_split()
        split_s = time.perf_counter() - t0
        train_c = data.load_corpus(runner.path("train"))
        test_c = data.load_corpus(runner.path("test"))
        check(train_c.packed_bits is not None and test_c.packed_bits is not None,
              "the link corpus is not bit-packed")
        sample = train_c.dense_batch(np.arange(min(len(train_c), 32)))
        check(np.all(np.tril(sample) == 0) and sample.sum(axis=1).max() <= s.max_parents,
              "corpus graphs are not forward DAGs within the in-degree cap")
        check(all(sorted(row.tolist()) == list(range(n)) for row in train_c.labels[:32]),
              "corpus labels are not permutations")
        out["corpus"] = {"graphs": len(train_c) + len(test_c), "train": len(train_c),
                         "test": len(test_c), "generate_s": gen_s, "split_s": split_s,
                         "edges_per_graph": float(sample.sum()) / len(sample)}
        print(f"link corpus: {json.dumps(out['corpus'])}")

        # 2. training, float32 and bfloat16 operands
        torch.cuda.reset_peak_memory_stats()
        train = {}
        state = None
        for md in (None, "bfloat16"):
            st, train[md or "float32"] = tier_train(torch, cfg, train_c, test_c, md,
                                                     os.path.join(tmp, f"trace_{md}"))
            if md is None:
                state = st
            else:
                del st
            torch.cuda.empty_cache()
        out["train"] = train
        peak_of("train")
        model = state.model

        # 3. checkpoint round trip, then eval on a few test graphs
        want = {k: v.clone() for k, v in model.state_dict().items()}
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(os.path.join(tmp, "ckpt"), TIER_FIT_EPOCHS,
                                   {"params": model.state_dict()})
        restored = checkpoint.restore_params(os.path.join(tmp, "ckpt"), TIER_FIT_EPOCHS,
                                             {k: torch.zeros_like(v) for k, v in want.items()})
        ckpt_s = time.perf_counter() - t0
        check(all(torch.equal(restored[k], v) for k, v in want.items()), "restored checkpoint differs")
        model.load_state_dict(restored)
        del want, restored
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = evaluate_corpus(model, test_c, TIER_EVAL_GRAPHS, seed=cfg.seed + 1,
                                  max_batches=1, use_isomorphism=False)
        eval_s = time.perf_counter() - t0
        check(metrics["valid_ratio_mode"] == 1.0, f"link valid_ratio_mode {metrics['valid_ratio_mode']}")
        out["checkpoint_eval"] = {"checkpoint_s": ckpt_s, "eval_s": eval_s,
                                  "eval_graphs": TIER_EVAL_GRAPHS, **metrics}
        peak_of("checkpoint_eval")
        print("link checkpoint + eval: " + json.dumps(out["checkpoint_eval"]))

        # 4. search through the scorer (fused entry) and the delta climb (family entry)
        dataset = runner.scoring_dataset()
        scorer = runner.scorer()
        check(scorer.impl == "kernel" and scorer.q_cap * scorer.r_max == 512,
              f"link scorer impl {scorer.impl}, S={scorer.q_cap * scorer.r_max}")
        steps: dict = {}

        def step(name, fn):
            torch.cuda.synchronize()
            reset_launches(trace_decodes=name in ("decode_and_score", "island_cem"))
            with held_launches(torch) as held:
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            steps[name] = {"seconds": seconds, "held": held, "launches": read_launches(),
                           "seconds_without_checks": seconds - held["check_s"]}
            return res

        pop = s.islands * s.island_population
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        z = torch.randn((pop, model.latent_size), generator=gen, device="cuda")
        scores, labels, adj = step("decode_and_score", lambda: decode_and_score(model, scorer, z, gen))
        info = steps["decode_and_score"]
        finite = torch.isfinite(scores)
        check(info["launches"]["node_scores_fused"] == 1 == info["held"]["score"]
              and bic_launches(info["launches"]) == 1,
              f"decode_and_score launches {info['launches']}")
        check_decodes(info["launches"], model, "link decode_and_score", decodes=1)
        check(bool(finite.any()), "no decoded link DAG scored finite")
        best = int(torch.argmax(scores))
        relabeled, _ = _relabel_and_check(labels, adj)
        info.update(population=pop, decodes_per_s=pop / info["seconds_without_checks"],
                    finite_fraction=float(finite.float().mean()),
                    mean_edges=float(adj.sum()) / pop,
                    best_bic=float(scores[best]),
                    best_bic_exact=check_exact(scorer, float(scores[best]),
                                               relabeled[best].cpu().numpy()))
        print("link decode_and_score: " + json.dumps(info))
        peak_of("decode_and_score")
        out["decode_attention"] = hold_decode(torch, model, pop, "link decode",
                                              max_in_degree=s.max_parents)
        fused_t = hold_fused(torch, scorer, relabeled, "decoded link population",
                             chunk=TIER_HOLD_CANDIDATES)
        del scores, labels, adj, relabeled
        peak_of("fused_timing")

        fam = FamilyBatchScorer(dataset, max_parents=s.max_parents, q_cap=scorer.q_cap, device="cuda")
        climb = step("delta_hill_climb", lambda: delta_hill_climb(
            fam, n, max_iters=s.hill_climb_iters, chunk=DELTA_CHUNK,
            time_budget_s=TIER_CLIMB_S, accept_batch=s.hill_climb_accept_batch))
        info = steps["delta_hill_climb"]
        check(info["launches"]["contingency_counts_family"] == info["held"]["family"] > 0
              and bic_launches(info["launches"]) == info["launches"]["contingency_counts_family"],
              f"delta climb launches {info['launches']}")
        check(all(b >= a for a, b in zip(climb.history, climb.history[1:])), "climb history decreased")
        info.update(moves=climb.iterations, converged=bool(climb.converged),
                    moves_per_s=climb.iterations / info["seconds_without_checks"],
                    family_evals=climb.num_evals,
                    family_evals_per_s=climb.num_evals / info["seconds_without_checks"],
                    edges=int(climb.best_adj.sum()), profile=climb.profile,
                    empty_graph_bic=climb.history[0], best_bic=climb.best_score,
                    best_bic_exact=check_exact(scorer, climb.best_score, climb.best_adj))
        print("link delta climb: " + json.dumps(info))
        peak_of("delta_hill_climb")

        isl = step("island_cem", lambda: islands.island_cem_search(
            model, scorer, seed=cfg.seed + 2, num_islands=s.islands,
            population=s.island_population, iters=TIER_ISLAND_ITERS,
            exploit_repeats=TIER_EXPLOIT, device="cuda"))
        info = steps["island_cem"]
        check(info["launches"]["node_scores_fused"] == TIER_ISLAND_ITERS + 1
              == info["held"]["score"] and bic_launches(info["launches"]) == TIER_ISLAND_ITERS + 1,
              f"island CEM launches {info['launches']}")
        check_decodes(info["launches"], model, "link island CEM")
        check(all(b >= a for a, b in zip(isl.history, isl.history[1:])), "island history decreased")
        info.update(evals=isl.num_evals, evals_per_s=isl.num_evals / info["seconds_without_checks"],
                    best_bic=isl.best_score, best_bic_exact=check_best_exact(torch, scorer, isl, n))
        print("link island CEM: " + json.dumps(info))
        peak_of("island_cem")

        seg_t = time_family_seg(torch, fam, climb.best_adj, max_rows=DELTA_CHUNK)
        peak_of("seg_timing")
    search_peak = max(peaks[k] for k in ("decode_and_score", "fused_timing", "delta_hill_climb",
                                         "island_cem", "seg_timing"))
    check(search_peak < TIER_PEAK_GIB, f"phase 14 search peak {search_peak:.2f} GiB")
    out.update(search=steps, fused=fused_t, family_seg=seg_t, peak_mem_gib=peaks, cuts=cuts)
    return out


def time_chunk(torch, trainer, state, train_c, log_dir, profile_steps) -> tuple:
    """One timed chunk of ``steps_per_call`` steps on random batches of the
    resident corpus (as the JAX bench times it), then ``profile_steps``
    steps under ``utils.profiling.trace``: step ms, graphs/s, the chunk's
    losses, peak memory, and the device time, launches and busy share of a
    step (the top kernels by device time)."""
    from dags_vae_search_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    k, b = trainer.config.steps_per_call, trainer.config.batch_size
    labels_d, adj_d = trainer.corpus_to_device(train_c, dev, log=lambda line: None)
    rng = np.random.default_rng(SEED)
    block = torch.as_tensor(rng.integers(0, len(train_c), size=(k, b)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.chunk_step(state, labels_d, adj_d, block, gen)
    losses = losses.cpu().numpy().astype(np.float64)
    chunk_s = time.perf_counter() - t0
    step_ms = chunk_s / k * 1e3
    out = {"chunk_steps": k, "batch": b, "chunk_s": chunk_s, "step_ms": step_ms,
           "graphs_per_s": k * b / chunk_s, "chunk_losses": losses.tolist(),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "profile_steps": profile_steps}
    pblock = torch.as_tensor(rng.integers(0, len(train_c), size=(profile_steps, b)), device=dev)
    with trace(log_dir) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.chunk_step(state, labels_d, adj_d, pblock, gen)
        torch.cuda.synchronize()
        out["profiled_wall_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / profile_steps
    device_ms, events, by_name = device_time(torch, prof)
    if events:
        device_ms /= profile_steps
        out.update(device_ms_per_step=device_ms, device_events_per_step=events / profile_steps,
                   device_busy_share=device_ms / step_ms,
                   top_kernels=[{"name": name[:100], "ms_per_step": us / 1e3 / profile_steps,
                                 "per_step": count / profile_steps}
                                for name, (us, count) in sorted(by_name.items(),
                                                                key=lambda kv: -kv[1][0])[:6]])
    else:
        out["device_busy_share"] = "not measured: the profiler recorded no device events"
    return state, out


def busy_text(record: dict) -> str:
    share = record["device_busy_share"]
    return share if isinstance(share, str) else f"{100 * share:.1f}%"


def chunk_card_vs_cpu(torch, cfg, train_c, batch=None, every_element=False) -> dict:
    """Phases 15-16: the registry's model (dropout and noise off) takes one
    chunk of ``SMALL_PARITY_STEPS`` steps of ``batch`` graphs (the
    registry's batch when None) on the card and on the CPU from the same
    seed and batches.  The chunk's losses to rtol 1e-4 / atol 1e-5; each
    step's gradients to 1e-4 norm-wise; the parameters after the chunk to
    rtol 1e-4 / atol 1e-5 where the two runs' gradients agree within
    ``DP_GRAD_RTOL`` of the CPU's at every step, as phase 13b holds them:
    Adam's step is about lr x sign(g) whatever |g|, so an element whose
    gradient is rounding noise (the attention key biases', zero in exact
    arithmetic) moves a full step either way.  Every element stays within
    Adam's reach of the CPU's, twice lr (1 - beta1) / sqrt(1 - beta2) a
    step.  The elements left out are counted, by tensor.  With
    ``every_element`` (phase 15) every parameter but the attention key
    biases is held to rtol 1e-4 / atol 1e-5 too."""
    from dags_vae_search_tpu_torch.models.pace_vae import make_model
    from dags_vae_search_tpu_torch.training.train import Trainer

    kwargs = dict(cfg.model_kwargs(), dropout=0.0, epsilon_scale=0.0)
    train = dataclasses.replace(cfg.train, batch_size=batch or cfg.train.batch_size)
    b, k = train.batch_size, SMALL_PARITY_STEPS
    corpus = train_c.take(np.arange(k * b))
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(make_model(SEED, dev, **kwargs), train)
        state = trainer.init_state(SEED)
        grads = []
        apply = trainer.apply_gradients

        def recorded(st, _apply=apply, _grads=grads):
            _grads.append({n: p.grad.detach().to("cpu", copy=True)
                           for n, p in st.model.named_parameters()})
            return _apply(st)

        trainer.apply_gradients = recorded
        labels_d, adj_d = trainer.corpus_to_device(corpus, torch.device(dev), log=lambda line: None)
        block = torch.arange(k * b, device=dev).reshape(k, b)
        state, losses = trainer.chunk_step(state, labels_d, adj_d, block,
                                           torch.Generator(device=dev).manual_seed(SEED))
        runs[dev] = (losses.cpu(), grads,
                     {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()})
        del trainer, state
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    grad_rel = []
    for card, cpu in zip(g_card, g_cpu):
        diff = sum(float(((card[n] - cpu[n]).double() ** 2).sum()) for n in cpu) ** 0.5
        grad_rel.append(diff / sum(float((g.double() ** 2).sum()) for g in cpu.values()) ** 0.5)
    reach = 2 * k * train.learning_rate * 0.1 / 0.001**0.5
    worst, left_out, total, outside, reached, failed = 0.0, {}, 0, 0, 0.0, []
    for name, want in p_cpu.items():
        agree = torch.ones_like(want, dtype=torch.bool)
        for card, cpu in zip(g_card, g_cpu):
            agree &= (card[name] - cpu[name]).abs() <= DP_GRAD_RTOL * cpu[name].abs()
        got = p_card[name]
        close = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
        if not close[agree].all() or (every_element and not name.endswith("k_proj.bias")
                                      and not close.all()):
            failed.append(name)
        if agree.any():
            worst = max(worst, float((got[agree] - want[agree]).abs().max()))
        reached = max(reached, float((got - want).abs().max()))
        outside += int((~close).sum())
        if not agree.all():
            left_out[name] = int((~agree).sum())
        total += want.numel()
    out = {"steps": k, "batch": b, "packed": train_c.packed_bits is not None,
           "max_abs_loss_diff": float((l_card - l_cpu).abs().max()),
           "grad_rel_diff_per_step": grad_rel, "max_abs_param_diff_where_grads_agree": worst,
           "max_abs_param_diff": reached, "adam_reach": reach,
           "params_left_out": sum(left_out.values()), "params": total,
           "params_outside_tolerance": outside,
           "left_out_by_tensor": dict(sorted(left_out.items(), key=lambda kv: -kv[1])[:6]),
           "losses_card": l_card.tolist()}
    print(f"{cfg.name} chunk card vs CPU: " + json.dumps(out))
    check(bool(torch.all(torch.isfinite(l_card))), f"{cfg.name}: non-finite chunk losses")
    check(torch.allclose(l_card, l_cpu, rtol=1e-4, atol=1e-5),
          f"{cfg.name} chunk losses card {l_card.tolist()} vs CPU {l_cpu.tolist()}")
    check(max(grad_rel) <= 1e-4, f"{cfg.name} chunk gradients card vs CPU {grad_rel} norm-wise")
    check(reached <= reach, f"{cfg.name}: a parameter {reached} from the CPU's, past Adam's reach")
    check(not failed, f"{cfg.name} chunk parameters outside rtol 1e-4 / atol 1e-5: {failed}")
    return out


def held_step(torch, steps: dict, key: str, fn, chunk=TIER_HOLD_CANDIDATES):
    """One path of phases 15-16 on its own: launches reset before it and
    read after it, every fused, seg and family launch held bit for bit
    against its plain version as it happens (the fused one ``chunk``
    candidates a call; the comparisons' seconds kept out), each entry's
    narrow and wide launches together equal to the calls held, peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with held_launches(torch, chunk) as held:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
    check_held(launches, held, key)
    steps[key] = {"seconds": seconds, "seconds_without_checks": seconds - held["check_s"],
                  "held": held, "launches": launches,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    return res


def check_table(torch, table, dataset, max_parents: int, label: str) -> dict:
    """The card's family table against one built on the CPU from the same
    data: the ``-inf`` pattern identical, finite entries to 1e-5 relative
    (float32 entropies summed in another order)."""
    from dags_vae_search_tpu_torch.scoring.family_table import FamilyTableScorer

    check(table.device.type == "cuda", f"{label}: the family table is on {table.device}")
    got = table._table_t.cpu().numpy()
    want = FamilyTableScorer(dataset, max_parents=max_parents, device="cpu")._table_t.numpy()
    check(np.array_equal(np.isneginf(got), np.isneginf(want)), f"{label}: -inf patterns differ")
    finite = np.isfinite(want)
    rel = np.abs(got[finite] - want[finite]) / np.abs(want[finite])
    check(finite.any() and np.all(np.isfinite(got[finite])) and float(rel.max()) <= 1e-5,
          f"{label}: family table entries differ from the CPU's by {float(rel.max())} relative")
    return {"shape": list(got.shape[::-1]), "infeasible": int((~finite).sum()),
            "max_rel_diff": float(rel.max())}


def check_small_search(torch, runner, report: dict, kept: dict, label: str) -> dict:
    """Phase 15's checks of one ``stage_search`` report: the family table
    and the exact optimum against the CPU's; every climb and latent best at
    or below the optimum and equal to its own float64 re-score."""
    from dags_vae_search_tpu_torch.scoring.bic import BicScorer
    from dags_vae_search_tpu_torch.search import exact

    ds, cfg = runner.scoring_dataset(), runner.config.search
    n = ds.num_variables
    check(len(kept["FamilyTableScorer"]) == len(kept["exact_search"]) == 1
          and len(kept["climb_with_restarts"]) == 1, f"{label}: {len(kept['exact_search'])} DPs")
    out = {"table": check_table(torch, kept["FamilyTableScorer"][0], ds, cfg.max_parents, label)}

    # the exact optimum: the CPU's DP, float64 re-scores on the card and on the host
    opt, card = kept["exact_search"][0], runner.scorer()
    cpu = BicScorer(ds, max_parents=cfg.max_parents, device="cpu")
    t0 = time.perf_counter()
    want = exact.exact_search(cpu, n, max_parents=min(cfg.max_parents or 4, 6))
    cpu_s = time.perf_counter() - t0
    optimum = report["exact_optimum"]["best_bic"]
    cpu_best = float(cpu.score_exact(want.best_adj[None])[0])
    host = float(card.score_exact_sparse(opt.best_adj[None])[0])
    check(report["exact_optimum"]["families"] == opt.num_families == want.num_families,
          f"{label}: {opt.num_families} families against the CPU's {want.num_families}")
    for name, value in (("the CPU's optimum", cpu_best), ("its host re-score", host)):
        check(abs(optimum - value) <= 1e-9 * abs(value), f"{label}: optimum {optimum} vs {name} "
                                                          f"{value}")
    check(abs(opt.best_score - optimum) <= 1e-5 * abs(optimum),
          f"{label}: DP value {opt.best_score} vs its float64 re-score {optimum}")

    def at_most_optimum(value, what):
        check(value is not None and np.isfinite(value)
              and value <= optimum + 1e-9 * abs(optimum), f"{label}: {what} {value} above the "
                                                          f"optimum {optimum}")

    hc = kept["climb_with_restarts"][0]
    hc_exact = report["hill_climb"]["best_bic"]
    check(abs(hc.best_score - hc_exact) <= 1e-5 * abs(hc_exact),
          f"{label}: climb best {hc.best_score} vs its float64 re-score {hc_exact}")
    at_most_optimum(hc_exact, "climb best")
    bests = {"hill_climb": hc_exact}
    if "island_cem_polished" in report:
        at_most_optimum(report["island_cem_polished"]["best_bic"], "polished climb best")
        bests["island_cem_polished"] = report["island_cem_polished"]["best_bic"]
    for key in ("island_cem", "latent_refined", "gp_ascent", "bo"):
        entry = report.get(key)
        if not isinstance(entry, dict):
            continue
        exact_value = entry.get("best_bic_exact")
        at_most_optimum(exact_value, f"{key} best")
        check(abs(entry["best_bic"] - exact_value) <= 1e-5 * abs(exact_value),
              f"{label}: {key} best {entry['best_bic']} vs its float64 re-score {exact_value}")
        bests[key] = exact_value
    for key, entry in report.get("budget_comparison", {}).items():
        if isinstance(entry, dict):
            at_most_optimum(entry["best_bic_exact"], f"budget {key} best")
            bests[f"budget_{key}"] = entry["best_bic_exact"]
    out.update(exact_optimum={**report["exact_optimum"], "cpu_best_bic": cpu_best,
                              "host_rescore": host, "dp_value_f32": opt.best_score,
                              "cpu_seconds": cpu_s},
               bests_exact=bests, hill_climb_impl=report["hill_climb"]["impl"],
               restarts=report["hill_climb"]["restarts"])
    check(out["hill_climb_impl"] == "dense", f"{label}: climb {out['hill_climb_impl']}")
    return out


def small_search(torch, runner, steps: dict, key: str) -> tuple:
    """``runner.stage_search`` as one held path of phase 15, keeping the
    family table, the exact DP's result and the dense climb it made."""
    from dags_vae_search_tpu_torch.scoring import family_table
    from dags_vae_search_tpu_torch.search import exact, hillclimb

    with kept_results((family_table, "FamilyTableScorer"), (exact, "exact_search"),
                      (hillclimb, "climb_with_restarts")) as kept:
        held_step(torch, steps, key, runner.stage_search)
    with open(os.path.join(runner.root, "report_search.json")) as fh:
        return json.load(fh), kept


def time_fused_routes(torch, scorer, adj, label: str) -> dict:
    """The fused entry on one input of the tiers' paths (held and timed on
    the route ``route()`` picks by :func:`hold_fused`), and both of its
    kernels launched directly on the same input: counts equal, times side
    by side."""
    from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch

    out = hold_fused(torch, scorer, adj, label, chunk=TIER_HOLD_CANDIDATES)
    strides, _ = bic_torch.parent_config_strides(adj, scorer._cards)
    args = (strides.transpose(1, 2).contiguous(), scorer._codes_cm, scorer._weights,
            scorer.q_cap, scorer.r_max)
    S = scorer.q_cap * scorer.r_max
    out["route"] = bic_kernel.route("fused", S,
                                    bic_kernel.fused_warp_bytes(S, adj.shape[-1]))
    out["S"] = S
    want = bic_kernel.contingency_counts_fused(*args)
    for name, wide in (("narrow", False), ("wide", True)):
        check(torch.equal(bic_kernel._launch_fused(*args, wide=wide), want),
              f"{label}: the {name} route's counts differ from the entry's")
        out[f"{name}_ms"] = cuda_ms(lambda: bic_kernel._launch_fused(*args, wide=wide), reps=10)
    print(f"{label}: narrow {out['narrow_ms']:.4f} ms, wide {out['wide_ms']:.4f} ms (route() "
          f"picks {out['route']}), bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


def sachs_fused_inputs(torch, n: int) -> dict:
    """The fused entry's inputs on sachs's two small-tier paths: the family
    table's first chunk (1,024 parent masks, every column carrying the
    mask) and the exact DP's chunk for node 0 (its 848 parent sets)."""
    from dags_vae_search_tpu_torch.search.exact import _family_masks

    masks = np.arange(1024, dtype=np.int64)
    bits = ((masks[:, None] >> np.arange(n)[None, :]) & 1).astype(np.float32)
    table = np.repeat(bits[:, :, None], n, axis=2)
    table[:, np.arange(n), np.arange(n)] = 0.0
    family = _family_masks(n, 6, 0)
    dp = np.zeros((family.shape[0], n, n), np.float32)
    dp[:, :, 0] = ((family[:, None] >> np.arange(n)[None, :]) & 1).astype(np.float32)
    return {"table_chunk": torch.as_tensor(table, device="cuda"),
            "exact_chunk": torch.as_tensor(dp, device="cuda")}


def small_config(name: str):
    """A copy of the registry's entry with phase 15's cuts (the shared
    registry is never edited): island CEM and refine iterations as phase 9
    cuts them; sachs simulated with three-state variables."""
    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY

    cfg = copy.deepcopy(REGISTRY[name])
    cfg.search.island_iters, cfg.search.refine_iters = ISLAND_ITERS, REFINE_ITERS
    if name == "sachs":
        cfg.dataset_csv, cfg.simulate_max_card = None, SMALL_SACHS_STATES
    return cfg


def cut_fit(runner) -> None:
    """The runner's train stage fits on the first ``SMALL_FIT_GRAPHS``
    graphs of its train split (``SMALL_FIT_GRAPHS / batch`` steps)."""
    load = runner._load_corpus
    runner._load_corpus = lambda split: (load(split).take(np.arange(SMALL_FIT_GRAPHS))
                                         if split == "train" else load(split))


def phase_small_tier(torch) -> dict:
    """Phase 15: the registry's small tier; checks in the module docstring."""
    from dags_vae_search_tpu_torch.experiments.runner import ExperimentRunner
    from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE, num_parameters
    from dags_vae_search_tpu_torch.training import data
    from dags_vae_search_tpu_torch.training.train import Trainer

    out: dict = {"card": nvidia_smi("name,power.limit"),
                 "cuts": {"fit_graphs": SMALL_FIT_GRAPHS, "island_iters": [30, ISLAND_ITERS],
                          "refine_iters": [15, REFINE_ITERS], "sachs_states": SMALL_SACHS_STATES}}
    steps: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = os.path.join(tmp, "runs")
        # (a) asia from generate to roundtrip
        cfg = small_config("asia")
        runner = ExperimentRunner(cfg, data_dir=runs, device="cuda")
        check(num_parameters(runner.model) == SMALL_PARAMS["asia"],
              f"asia model has {num_parameters(runner.model)} parameters")
        held_step(torch, steps, "asia_generate", runner.stage_generate)
        held_step(torch, steps, "asia_split", runner.stage_split)
        train_c = data.load_corpus(runner.path("train"))
        check(len(train_c) == SMALL_ASIA_TRAIN and train_c.packed_bits is None,
              f"asia train split {len(train_c)} graphs")
        check(not cfg.model.edge_readout, "asia: the model has an edge readout")
        out["asia_chunk_card_vs_cpu"] = chunk_card_vs_cpu(torch, cfg, train_c, every_element=True)
        trainer = Trainer(PaceVAE(**cfg.model_kwargs()).to("cuda"), cfg.train)
        torch.cuda.reset_peak_memory_stats()
        _, chunk = time_chunk(torch, trainer, trainer.init_state(cfg.seed), train_c,
                              os.path.join(tmp, "trace_asia"), TIER_PROFILE_STEPS)
        chunk["epoch_steps"] = len(train_c) // cfg.train.batch_size
        chunk["projected_epoch_s"] = chunk["epoch_steps"] * chunk["step_ms"] / 1e3
        out["asia_chunk"] = chunk
        print(f"asia train chunk: step {chunk['step_ms']:.3f} ms over {chunk['chunk_steps']} x "
              f"{chunk['batch']} graphs, device busy {busy_text(chunk)}, a full epoch of "
              f"{chunk['epoch_steps']} steps would take {chunk['projected_epoch_s']:.1f} s")
        del trainer, train_c
        cut_fit(runner)
        held_step(torch, steps, "asia_train", lambda: runner.stage_train(epochs=1))
        held_step(torch, steps, "asia_eval", lambda: runner.stage_eval(use_isomorphism=False))
        held_step(torch, steps, "asia_predictor", runner.stage_predictor)
        held_step(torch, steps, "asia_gp", runner.stage_gp)
        report, kept = small_search(torch, runner, steps, "asia_search")
        out["asia"] = check_small_search(torch, runner, report, kept, "asia")
        held_step(torch, steps, "asia_roundtrip", runner.stage_roundtrip)
        reports = {}
        for stage in PIPELINE_STAGES:
            for root in (runner.root, runner.reports_root):
                check(os.path.isfile(os.path.join(root, f"report_{stage}.json")),
                      f"missing {root}/report_{stage}.json")
            with open(os.path.join(runner.root, f"report_{stage}.json")) as fh:
                reports[stage] = json.load(fh)
        check(not _skipped(reports), f"asia: skipped report entries {_skipped(reports)}")
        final = reports["train"]["final"]
        check(all(np.isfinite(final[k]) for k in ("loss_per_graph", "recon_per_graph",
                                                   "kld_per_graph")), f"asia losses {final}")
        (fit,) = reports["train"]["history"]
        check(abs(fit["graphs_per_second"] * fit["epoch_seconds"] - SMALL_FIT_GRAPHS) < 1.0,
              f"asia fit on {fit['graphs_per_second'] * fit['epoch_seconds']:.1f} graphs")
        out["asia"].update(
            rows=reports["generate"]["rows"], train_rows=reports["split"]["train_rows"],
            fit=final, eval={k: v for k, v in reports["eval"].items()
                             if k not in ("stage", "time", "device")},
            gp={k: reports["gp"][k] for k in ("model", "train_points", "mae", "mape")},
            roundtrip={k: reports["roundtrip"][k] for k in ("true_bic", "relative_error",
                                                             "decode_valid")})
        check(out["asia"]["rows"] == SMALL_ASIA_CORPUS, f"asia corpus {out['asia']['rows']} graphs")
        print(f"asia: valid_ratio_mode {reports['eval']['valid_ratio_mode']}, exact optimum "
              f"{out['asia']['exact_optimum']['best_bic']:.4f}, bests {out['asia']['bests_exact']}")

        # (b) sachs with three states: the structure search, then the routes timed
        cfg = small_config("sachs")
        runner = ExperimentRunner(cfg, data_dir=runs, variant="structure", device="cuda")
        scorer = runner.scorer()
        check((scorer.q_cap, scorer.r_max, scorer.impl) == (4096, 3, "kernel"),
              f"sachs scorer q_cap {scorer.q_cap}, r_max {scorer.r_max}, {scorer.impl}")
        report, kept = small_search(torch, runner, steps, "sachs_search")
        check(report["island_cem"] == "skipped (no checkpoint)", "sachs ran the latent half")
        out["sachs"] = check_small_search(torch, runner, report, kept, "sachs")
        launches = steps["sachs_search"]["launches"]
        scores = launches["node_scores_fused"] + launches["node_scores_fused_wide"]
        counts = launches["contingency_counts_fused"] + launches["contingency_counts_fused_wide"]
        # the score entry: the table's 2 chunks and the DP's one chunk per
        # node; the fused entry: the float64 re-scores of the optimum, the
        # climb and the ground truth; each on either route
        check(scores == 2 + 11 and counts == 3, f"sachs search: launches {launches}")
        sachs_inputs = sachs_fused_inputs(torch, scorer.dataset.num_variables)
        out["sachs"]["fused"] = {
            key: time_fused_routes(torch, scorer, adj, f"sachs {key}")
            for key, adj in sachs_inputs.items()}
        out["sachs"]["score"] = {
            key: time_score_entry(torch, scorer, adj, f"sachs {key}", chunk=TIER_HOLD_CANDIDATES)
            for key, adj in sachs_inputs.items()}
        del sachs_inputs

        # (c) synthetic_12 with one label: generate, split, fit, search
        cfg = small_config("synthetic_12")
        runner = ExperimentRunner(cfg, data_dir=runs, device="cuda")
        check(runner.model.cardinality == 4, "synthetic_12 is not one-label")
        held_step(torch, steps, "synthetic_12_generate", runner.stage_generate)
        held_step(torch, steps, "synthetic_12_split", runner.stage_split)
        cut_fit(runner)
        held_step(torch, steps, "synthetic_12_train", lambda: runner.stage_train(epochs=1))
        report, kept = small_search(torch, runner, steps, "synthetic_12_search")
        check(not _skipped(report), f"synthetic_12: skipped {_skipped(report)}")
        check(isinstance(report.get("island_cem"), dict), "synthetic_12 ran no island CEM")
        out["synthetic_12"] = check_small_search(torch, runner, report, kept, "synthetic_12")
    out["steps"] = steps
    for key, info in steps.items():
        launches = info["launches"]
        print(f"small tier {key}: {info['seconds']:.3f} s ({info['seconds_without_checks']:.3f} s "
              f"without the checks), score {launches['node_scores_fused']} narrow + "
              f"{launches['node_scores_fused_wide']} wide (held {info['held']['score']}), "
              f"fused {launches['contingency_counts_fused']} narrow + "
              f"{launches['contingency_counts_fused_wide']} wide (held {info['held']['fused']}), "
              f"peak {info['peak_mem_gib']:.3f} GiB")
    return out


def large_config(**changes):
    """A copy of the registry's hepar2 entry with phase 16's cuts (the
    shared registry is never edited), and ``changes`` to its fields."""
    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY

    cfg = copy.deepcopy(REGISTRY[LARGE_NAME])
    cfg.search.island_iters, cfg.search.refine_iters = ISLAND_ITERS, REFINE_ITERS
    cfg.train.checkpoint_every = LARGE_FIT_EPOCHS
    for key, value in changes.items():
        setattr(cfg, key, value)
    return cfg


def check_climbs(climbs: list, report: dict, label: str) -> dict:
    """The delta climbs ``stage_search`` made (the restarts, then the
    polish climb when it ran): each history non-decreasing, the restart
    history one entry a climb, 1-5 of them, none below the first."""
    hc = report["hill_climb"]
    restarts = hc["restart_history"]
    check(hc["impl"] == "delta", f"{label}: climb {hc['impl']}")
    check(1 <= len(restarts) <= 5 and all(h >= restarts[0] for h in restarts),
          f"{label}: restart history {restarts}")
    for res in climbs:
        check(all(b >= a for a, b in zip(res.history, res.history[1:])),
              f"{label}: a climb's history decreased")
    check(len(climbs) in (len(restarts), len(restarts) + 1),
          f"{label}: {len(climbs)} climbs for {len(restarts)} restart entries")
    return {"restart_history": restarts, "climbs": len(climbs),
            "moves": [res.iterations for res in climbs],
            "family_evals": [res.num_evals for res in climbs],
            "profiles": [res.profile for res in climbs]}


def phase_large_tier(torch) -> dict:
    """Phase 16: the registry's large tier at hepar2; checks in the module
    docstring."""
    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
    from dags_vae_search_tpu_torch.experiments.runner import ExperimentRunner
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE, num_parameters
    from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
    from dags_vae_search_tpu_torch.search import delta_hillclimb, hillclimb
    from dags_vae_search_tpu_torch.training import checkpoint, data
    from dags_vae_search_tpu_torch.training.train import Trainer

    base = REGISTRY[LARGE_NAME]
    out: dict = {"card": nvidia_smi("name,power.limit"), "cuts": {
        "fit_epochs": [base.train.epochs, LARGE_FIT_EPOCHS],
        "checkpoint_every": [base.train.checkpoint_every, LARGE_FIT_EPOCHS],
        "island_iters": [base.search.island_iters, ISLAND_ITERS],
        "refine_iters": [base.search.refine_iters, REFINE_ITERS],
        "eval_batches": [20, LARGE_EVAL_BATCHES]}}
    steps: dict = {}

    def step(key, fn):
        return held_step(torch, steps, key, fn, chunk=LARGE_HOLD_CANDIDATES)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) hepar2 from generate to roundtrip
        cfg = large_config()
        runner = ExperimentRunner(cfg, data_dir=os.path.join(tmp, "runs"), device="cuda")
        n, s = cfg.num_vertices, cfg.search
        params = num_parameters(runner.model)
        check(params == LARGE_PARAMS, f"hepar2 model has {params} parameters, want {LARGE_PARAMS:,}")
        step("large_generate", runner.stage_generate)
        step("large_split", runner.stage_split)
        train_c = data.load_corpus(runner.path("train"))
        test_c = data.load_corpus(runner.path("test"))
        check(train_c.packed_bits is not None and test_c.packed_bits is not None
              and train_c.packed_bits.shape[1:] == (n, 9), "the hepar2 corpus is not bit-packed")
        check(len(train_c) == LARGE_TRAIN and len(train_c) + len(test_c) == LARGE_CORPUS,
              f"hepar2 corpus {len(train_c)} + {len(test_c)} graphs")
        sample = train_c.dense_batch(np.arange(256))
        check(np.all(np.tril(sample) == 0) and sample.sum(axis=1).max() <= s.max_parents,
              "corpus graphs are not forward DAGs within the in-degree cap")
        check(all(sorted(row.tolist()) == list(range(n)) for row in train_c.labels[:256]),
              "corpus labels are not permutations")
        out["corpus"] = {"graphs": len(train_c) + len(test_c), "train": len(train_c),
                         "test": len(test_c), "packed_bytes_per_row": train_c.packed_bits.shape[2],
                         "edges_per_graph": float(sample.sum()) / len(sample)}

        out["chunk_card_vs_cpu"] = chunk_card_vs_cpu(torch, cfg, train_c, LARGE_PARITY_BATCH)
        trainer = Trainer(PaceVAE(**cfg.model_kwargs()).to("cuda"), cfg.train)
        torch.cuda.reset_peak_memory_stats()
        _, chunk = time_chunk(torch, trainer, trainer.init_state(cfg.seed), train_c,
                              os.path.join(tmp, "trace_hepar2"), TIER_PROFILE_STEPS)
        chunk["epoch_steps"] = len(train_c) // cfg.train.batch_size
        chunk["projected_epoch_s"] = chunk["epoch_steps"] * chunk["step_ms"] / 1e3
        out["train_chunk"] = chunk
        print(f"hepar2 train chunk: step {chunk['step_ms']:.3f} ms over {chunk['chunk_steps']} x "
              f"{chunk['batch']} graphs, device busy {busy_text(chunk)}, peak "
              f"{chunk['peak_mem_gib']:.3f} GiB; an epoch of {chunk['epoch_steps']} steps "
              f"projects at {chunk['projected_epoch_s']:.1f} s")
        del trainer
        torch.cuda.empty_cache()

        step("large_train", lambda: runner.stage_train(epochs=LARGE_FIT_EPOCHS))
        # the checkpoint the stage wrote at its last epoch restores bit-equal
        want = runner.model.state_dict()
        t0 = time.perf_counter()
        restored = checkpoint.restore_params(runner.path("checkpoints"), LARGE_FIT_EPOCHS,
                                             {k: torch.zeros_like(v) for k, v in want.items()})
        check(all(torch.equal(restored[k], v) for k, v in want.items()),
              "the restored hepar2 checkpoint differs from the trained model")
        out["checkpoint_restore_s"] = time.perf_counter() - t0
        del want, restored
        step("large_eval", lambda: runner.stage_eval(max_batches=LARGE_EVAL_BATCHES,
                                                      use_isomorphism=False))
        step("large_predictor", runner.stage_predictor)
        step("large_gp", runner.stage_gp)
        with kept_results((hillclimb, "climb_with_restarts"),
                          (delta_hillclimb, "delta_hill_climb")) as kept:
            step("large_search", runner.stage_search)
        step("large_roundtrip", runner.stage_roundtrip)

        reports = {}
        for stage in PIPELINE_STAGES:
            for root in (runner.root, runner.reports_root):
                check(os.path.isfile(os.path.join(root, f"report_{stage}.json")),
                      f"missing {root}/report_{stage}.json")
            with open(os.path.join(runner.root, f"report_{stage}.json")) as fh:
                reports[stage] = json.load(fh)
        check(not _skipped(reports), f"hepar2: skipped report entries {_skipped(reports)}")
        check(reports["generate"]["rows"] == LARGE_CORPUS, "hepar2 corpus rows")
        (fit,) = reports["train"]["history"]
        check(all(np.isfinite(fit[k]) for k in ("loss_per_graph", "recon_per_graph",
                                                 "kld_per_graph")), f"hepar2 losses {fit}")
        check(reports["eval"]["valid_ratio_mode"] == 1.0,
              f"hepar2 valid_ratio_mode {reports['eval']['valid_ratio_mode']}")

        # the search stage: every climb, every best against its re-scores
        search = reports["search"]
        (hc,) = kept["climb_with_restarts"]
        climbs = kept["delta_hill_climb"]
        out["climbs"] = check_climbs(climbs, search, "hepar2")
        scorer = runner.scorer()
        host = float(scorer.score_exact_sparse(hc.best_adj[None])[0])
        hc_exact = search["hill_climb"]["best_bic"]
        check(abs(hc.best_score - hc_exact) <= 1e-5 * abs(hc_exact),
              f"climb best {hc.best_score} vs its float64 re-score {hc_exact}")
        check(abs(host - hc_exact) <= 1e-9 * abs(host), f"climb best {hc_exact} vs host {host}")
        bests = {"hill_climb": {"f32": hc.best_score, "exact": hc_exact, "host": host}}
        check("island_cem_polished" in search, "hepar2: no polish climb")
        polish = search["island_cem_polished"]["best_bic"]
        check(len(climbs) == len(search["hill_climb"]["restart_history"]) + 1
              and abs(climbs[-1].best_score - polish) <= 1e-5 * abs(polish),
              f"polish climb best {climbs[-1].best_score} vs its float64 re-score {polish}")
        bests["island_cem_polished"] = {"f32": climbs[-1].best_score, "exact": polish}
        for key in ("island_cem", "latent_refined", "gp_ascent", "bo"):
            entry = search[key]
            exact_value = entry.get("best_bic_exact")
            check(exact_value is not None and np.isfinite(exact_value)
                  and abs(entry["best_bic"] - exact_value) <= 1e-5 * abs(exact_value),
                  f"hepar2 {key} best {entry['best_bic']} vs its float64 re-score {exact_value}")
            bests[key] = {"f32": entry["best_bic"], "exact": exact_value}
        out["hepar2"] = {
            "bests": bests, "ground_truth_bic": search["ground_truth_bic"],
            "hill_climb": {k: search["hill_climb"][k] for k in
                           ("iterations", "evals", "seconds", "evals_per_sec", "restarts")},
            "island_cem_subspace": search["island_cem"]["subspace"],
            "fit": fit, "eval": {k: v for k, v in reports["eval"].items()
                                 if k not in ("stage", "time", "device")},
            "predictor": {k: reports["predictor"][k] for k in ("rows", "finite_fraction")},
            "gp": {k: reports["gp"][k] for k in ("model", "train_points", "mae", "mape")},
            "roundtrip": {k: reports["roundtrip"][k] for k in ("true_bic", "gp_predicted_bic",
                                                                "relative_error", "decode_valid")}}
        check(out["hepar2"]["gp"]["model"] == "ExactGP", "the hepar2 GP is not the exact GP")
        launches = steps["large_search"]["launches"]
        check(launches["decode_attention"] > 0, f"hepar2 search: launches {launches}")
        check(launches["contingency_counts_family"] > 0 and launches["node_scores_fused"] > 0
              and launches["contingency_counts_fused"] > 0
              and launches["contingency_counts"] == launches["contingency_counts_wide"] == 0,
              f"hepar2 search launches {launches}")
        # the family narrow kernel at the binary climbs' shapes: an accept
        # batch's refresh (8 children) and a full chunk
        fam = FamilyBatchScorer(runner.scoring_dataset(), max_parents=s.max_parents,
                                q_cap=scorer.q_cap, device="cuda")
        out["family_seg"] = time_family_seg(torch, fam, climbs[0].best_adj, max_rows=DELTA_CHUNK,
                                            refresh_children=s.hill_climb_accept_batch)
        del fam
        print(f"hepar2: bests {json.dumps(bests)}, ground truth {search['ground_truth_bic']:.4f}, "
              f"restart history {out['climbs']['restart_history']}")

        # (b) four-state data: the structure search, then both routes timed
        cfg = large_config(simulate_max_card=LARGE_STATES, dataset_csv=None)
        runner = ExperimentRunner(cfg, data_dir=os.path.join(tmp, "runs_four"),
                                  variant="structure", device="cuda")
        scorer = runner.scorer()
        S = scorer.q_cap * scorer.r_max
        check((scorer.q_cap, scorer.r_max, S) == (4096, LARGE_STATES, 16_384)
              and scorer.impl == "kernel", f"four-state scorer q_cap {scorer.q_cap}, "
                                           f"r_max {scorer.r_max}, {scorer.impl}")
        with kept_results((hillclimb, "climb_with_restarts"),
                          (delta_hillclimb, "delta_hill_climb")) as kept:
            step("large_four_state_search", runner.stage_search)
        with open(os.path.join(runner.root, "report_search.json")) as fh:
            search = json.load(fh)
        check(search["island_cem"] == "skipped (no checkpoint)", "four states: ran the latent half")
        launches = steps["large_four_state_search"]["launches"]
        check(launches["contingency_counts_family"] + launches["contingency_counts_family_wide"] > 0
              and launches["contingency_counts"] == launches["contingency_counts_wide"] == 0,
              f"four-state search launches {launches}")
        climbs = kept["delta_hill_climb"]
        four = {"S": S, "unique_rows": scorer.num_unique_rows,
                "climbs": check_climbs(climbs, search, "four states")}
        (hc,) = kept["climb_with_restarts"]
        hc_exact = search["hill_climb"]["best_bic"]
        host = float(scorer.score_exact_sparse(hc.best_adj[None])[0])
        check(abs(hc.best_score - hc_exact) <= 1e-5 * abs(hc_exact)
              and abs(host - hc_exact) <= 1e-9 * abs(host),
              f"four states: climb best {hc.best_score} / {hc_exact} / host {host}")
        four.update(best_bic={"f32": hc.best_score, "exact": hc_exact, "host": host},
                    ground_truth_bic=search["ground_truth_bic"])
        fam = FamilyBatchScorer(runner.scoring_dataset(), max_parents=s.max_parents,
                                q_cap=scorer.q_cap, device="cuda")
        four["family_seg"] = time_family_seg(torch, fam, hc.best_adj, max_rows=DELTA_CHUNK)
        _, pop = sampler.sample_connected_dags(np.random.default_rng(SEED), LARGE_POPULATION, n,
                                               123, n, max_in_degree=s.max_parents)
        pop = torch.as_tensor(pop, device="cuda")
        four["fused"] = time_fused_routes(torch, scorer, pop, "hepar2 four-state population")
        four["score"] = time_score_entry(torch, scorer, pop, "hepar2 four-state population",
                                         chunk=TIER_HOLD_CANDIDATES)
        del pop
        out["four_states"] = four
        first, full = four["family_seg"]["first"], four["family_seg"]["full"]
        print(f"hepar2 four states (S = {S}, {nvidia_smi('name,power.limit')}): family entry "
              f"narrow / wide first frontier {first['family_narrow_ms']:.4f} / "
              f"{first['family_wide_ms']:.4f} ms, full chunk {full['family_narrow_ms']:.4f} / "
              f"{full['family_wide_ms']:.4f} ms (bound {full['bound_ms']:.4f}); seg narrow / wide "
              f"full chunk {full['seg_narrow_ms']:.4f} / {full['seg_wide_ms']:.4f} ms (bound "
              f"{full['seg_bound']['bound_ms']:.4f}); fused narrow / wide "
              f"{four['fused']['narrow_ms']:.4f} / {four['fused']['wide_ms']:.4f} ms (bound "
              f"{four['fused']['bound_ms']:.4f})")
    out["steps"] = steps
    for key, info in steps.items():
        launches = info["launches"]
        print(f"large tier {key}: {info['seconds']:.3f} s ({info['seconds_without_checks']:.3f} s "
              f"without the checks), score {launches['node_scores_fused']} + "
              f"{launches['node_scores_fused_wide']} wide, fused "
              f"{launches['contingency_counts_fused']} + "
              f"{launches['contingency_counts_fused_wide']} wide, family "
              f"{launches['contingency_counts_family']} + "
              f"{launches['contingency_counts_family_wide']} wide, peak "
              f"{info['peak_mem_gib']:.3f} GiB")
    return out


def kernel_records(search: dict, er: dict, decoded: dict, stage: dict, wide: dict, tier: dict,
                   small: dict, large: dict, sweep: dict, launches_by_path: dict) -> list:
    """The kernels' records, each route at its main path's inputs: the score
    entry and the fused entry on the decoded population (the latent
    search's), the score entry's wide route on phase 11's dense climb chunk
    (its largest difference from the plain version over every held launch
    and timed input), the family entry
    and the seg entry on the delta climb's first frontier at alarm width,
    the wide routes on phase 11's dense climb chunk and delta climb's first
    frontier; the other inputs' times beside them (phase 14's at link
    width, phase 15's at sachs with three states, phase 16's at hepar2 with
    four states) and the route sweep's times.  ``launches`` sums the main
    paths' runs, each read on its own."""
    family, fused_stage = stage["family_seg"], stage["fused_stage"]
    sachs = small["sachs"]["fused"]
    four = large["four_states"]
    chunks = [*family.values(), *tier["family_seg"].values(), *four["family_seg"].values(),
              *wide["family_seg"].values(), *large["family_seg"].values()]
    # the family narrow kernel at the climbs' shapes
    climb_shapes = {"alarm": family, "link": tier["family_seg"], "hepar2": large["family_seg"],
                    "hepar2_four_states": four["family_seg"]}
    at_climb_shapes = {f"{where}_{key}": {k: rec[k] for k in (
        "F", "U", "S", "cluster", "family_narrow_ms", "device_ms", "bound_ms", "bound_by")
        if k in rec}
        for where, recs in climb_shapes.items() for key, rec in recs.items()}
    errs = {"fused": [f["err"] for f in [*fused_stage.values(), *sachs.values(), four["fused"]]],
            "seg": [f["err"] for f in chunks]}

    def swept(entry):
        return {f"U{p['U']}_S{p['S']}": {"narrow_ms": p["narrow_ms"], "wide_ms": p["wide_ms"]}
                for p in sweep["points"] if p["entry"] == entry}

    def record(name, main, library_ms, extra):
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": sum(path[name] for path in launches_by_path.values()),
                "launches_by_path": {p: path[name] for p, path in launches_by_path.items()},
                **main, "library_ms": library_ms, **extra}

    def family_main(chunk, route, inputs):
        return {"max_abs_err": max(f["err"] for f in chunks), "ms": chunk[f"family_{route}_ms"],
                "plain_ms": chunk["family_plain_ms"], "bound_ms": chunk["bound_ms"],
                "bound_by": chunk["bound_by"], "inputs": inputs, "bytes": chunk["bytes"],
                "int_ops": chunk["int_ops"]}

    first, wide_first = family["first"], wide["family_seg"]["first"]
    chunk = wide["fused_climb_chunk"]
    shape = "F={F}, U={U}, S={S}, P={P}"
    scored = {"decoded_population": decoded["score_entry"], **{
        f"stage_{k}": v for k, v in stage["score_stage"].items()},
        "barley_climb_chunk": wide["score_climb_chunk"],
        **{f"sachs_{k}": v for k, v in small["sachs"]["score"].items()},
        "hepar2_four_state_population": large["four_states"]["score"]}
    helds = [search["held"], *[v["held"] for part in (stage["steps"], wide["steps"], tier["search"],
                                                      small["steps"], large["steps"])
                               for v in part.values()]]
    score_err = max([h["score_err"] for h in helds] + [v["err"] for v in scored.values()])
    score_ptxas = {k: v for k, v in ptxas_report().items()
                   if "node_scores" in k or "ReduceScore" in k}

    def score_main(rec, inputs):
        return {"max_abs_err": score_err, "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "inputs": inputs,
                "bytes": rec["bytes"], "int_ops": rec["int_ops"], "float_ops": rec["float_ops"]}

    dec, barley = scored["decoded_population"], scored["barley_climb_chunk"]
    attn, link_attn = decoded["decode_attention"], tier["decode_attention"]
    return [
        {"name": "decode_attention", "route": "cuda", "source": DECODE_SOURCE,
         "replaces": "none: XLA lowers the JAX decode's attention; the port's cached decode",
         "launches": sum(path["decode_attention"] for path in launches_by_path.values()),
         "launches_by_path": {p: path["decode_attention"] for p, path in launches_by_path.items()
                              if path["decode_attention"]},
         "held_calls": attn["calls"] + link_attn["calls"],
         "max_rel_err": max(attn["max_rel_err"], link_attn["max_rel_err"]),
         "tolerance": {"of_largest_output": DECODE_RTOL},
         "ms": attn["ms"], "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
         "bound_by": attn["bound_by"], "bytes": attn["bytes"], "int_ops": 0.0,
         "inputs": f"one alarm island decode ({attn['rows']} rows x {attn['heads']} heads, "
                   f"d_head {attn['d_head']}, L 1-{attn['positions']}, its own masks), "
                   f"{attn['calls']} launches summed",
         "library_ms": None,
         "library": "none: the port calls no library attention; plain_ms is the path the "
                    "kernel replaced (baddbmm, softmax, bmm)",
         "by_layout": attn["by_layout"], "link_decode": link_attn,
         "ptxas": ptxas_report("decode_attention")},
        record("node_scores_fused", score_main(dec, "decoded population"), None, {
            "library": "none: no one PyTorch call computes the counts and the scores",
            "tolerance": {"rtol": SCORE_RTOL, "atol": SCORE_ATOL, "between_launches": 0.0},
            "held_calls": sum(h["score"] for h in helds), "entry_ms": dec["entry_ms"],
            "at_inputs": {k: v for k, v in scored.items() if v["route"] == "narrow"},
            "ptxas": score_ptxas,
        }),
        record("node_scores_fused_wide", score_main(
            barley, f"dense climb chunk at barley width (R={barley['rows']}, S={barley['S']})"),
            None, {
                "library": "none: no one PyTorch call computes the counts and the scores",
                "tiles": barley["tiles"], "entry_ms": barley["entry_ms"],
                "at_inputs": {k: v for k, v in scored.items() if v["route"] == "wide"},
                "ptxas": score_ptxas,
            }),
        record("contingency_counts_fused", {
            "max_abs_err": max(er["err_fused"], decoded["err_fused"], *errs["fused"]),
            "ms": decoded["fused_ms"], "plain_ms": decoded["fused_plain_ms"],
            "bound_ms": decoded["fused_bound_ms"], "bound_by": decoded["fused_bound_by"],
            "inputs": "decoded population", "bytes": decoded["fused_bytes"],
            "int_ops": decoded["fused_int_ops"],
        }, None, {
            "narrow_max_bins": sweep["rule"]["fused"],
            "ms_er": er["fused_ms"], "plain_ms_er": er["fused_plain_ms"],
            "bound_ms_er": er["fused_bound_ms"],
            "small_span_ms": decoded["small_span_ms"], "small_span_ms_er": er["small_span_ms"],
            "stage_climb_chunk": fused_stage["climb_chunk"],
            "stage_island_population": fused_stage["island_population"],
            "link_decoded_population": tier["fused"],
            "sachs_table_chunk": sachs["table_chunk"],
            "sachs_exact_chunk": sachs["exact_chunk"],
            "hepar2_four_state_population": four["fused"],
            "route_sweep": swept("fused"),
        }),
        record("contingency_counts_fused_wide", {
            "max_abs_err": chunk["err"], "ms": chunk["ms"], "plain_ms": chunk["plain_ms"],
            "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
            "inputs": f"dense climb chunk at barley width (R={chunk['rows']}, S=65536)",
            "bytes": chunk["bytes"], "int_ops": chunk["int_ops"],
        }, None, {**{f"sachs_{key}_ms": sachs[key]["wide_ms"] for key in sachs},
                  "hepar2_four_state_population_ms": four["fused"]["wide_ms"]}),
        record("contingency_counts_family", family_main(
            first, "narrow", "delta climb's first frontier at alarm width (" + shape.format(**first)
            + ")"), None, {
            "narrow_max_bins": sweep["rule"]["family"],
            "library": "none: no one PyTorch call computes the cells and the counts",
            "bincount_on_cells_ms": first["bincount_ms"],
            "design": "a family's unique rows split over a thread-block cluster, merged in "
                      "distributed shared memory",
            "at_climb_shapes": at_climb_shapes,
            "ptxas": {k: v for k, v in ptxas_report().items() if "family_cluster_kernel" in k},
            "family_refresh": family["refresh"], "family_final_refresh": family["final"],
            "family_full_chunk": family["full"], "link_family": tier["family_seg"],
            "hepar2_family": large["family_seg"],
            "hepar2_four_state_family": four["family_seg"], "route_sweep": swept("family"),
        }),
        record("contingency_counts_family_wide", family_main(
            wide_first, "wide", "delta climb's first frontier at barley width ("
            + shape.format(**wide_first) + ")"), None, {
            "library": "none: no one PyTorch call computes the cells and the counts",
            "bincount_on_cells_ms": wide_first["bincount_ms"],
            "family_full_chunk": wide["family_seg"]["full"],
            "hepar2_four_state_ms": {k: v["family_wide_ms"] for k, v in four["family_seg"].items()},
        }),
        record("contingency_counts", {
            "max_abs_err": max(er["err_seg"], decoded["err_seg"], *errs["seg"]),
            "ms": first["seg_narrow_ms"], "plain_ms": first["seg_plain_ms"],
            "bound_ms": first["seg_bound"]["bound_ms"], "bound_by": first["seg_bound"]["bound_by"],
            "inputs": "cells of the delta climb's first frontier at alarm width ("
                      + shape.format(**first) + "), timing calls only",
            "bytes": first["seg_bound"]["bytes"], "int_ops": first["seg_bound"]["int_ops"],
        }, first["bincount_ms"], {
            "narrow_max_bins": sweep["rule"]["seg"],
            "ms_er": er["seg_ms"], "plain_ms_er": er["seg_plain_ms"],
            "bound_ms_er": er["seg_bound_ms"], "library_ms_er": er["bincount_ms"],
            "ms_decoded": decoded["seg_ms"], "plain_ms_decoded": decoded["seg_plain_ms"],
            "bound_ms_decoded": decoded["seg_bound_ms"], "library_ms_decoded": decoded["bincount_ms"],
            "route_sweep": swept("seg"),
        }),
        record("contingency_counts_wide", {
            "max_abs_err": max(errs["seg"]), "ms": wide_first["seg_wide_ms"],
            "plain_ms": wide_first["seg_plain_ms"], "bound_ms": wide_first["seg_bound"]["bound_ms"],
            "bound_by": wide_first["seg_bound"]["bound_by"],
            "inputs": "cells of the delta climb's first frontier at barley width ("
                      + shape.format(**wide_first) + "), timing calls only",
            "bytes": wide_first["seg_bound"]["bytes"], "int_ops": wide_first["seg_bound"]["int_ops"],
        }, wide_first["bincount_ms"], {
            "hepar2_four_state_ms": {k: v["seg_wide_ms"] for k, v in four["family_seg"].items()},
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

    er = phase_kernels(torch, cfg, scorer)
    t_sweep = time.perf_counter()
    sweep = phase_route_sweep(torch)
    print(f"route sweep {time.perf_counter() - t_sweep:.1f} s")
    phase_card_vs_cpu(torch, cfg, scorer, dataset)
    phase_train_card_vs_cpu(torch)
    search, decoded = phase_search(torch, cfg, scorer)
    print("search:", json.dumps(search))
    trainer, state, corpus, train_c, test_c, train = phase_train(torch, cfg)
    train["eval"] = phase_checkpoint_eval(torch, cfg, state.model, test_c)
    train["search"] = phase_train_search(torch, cfg, scorer, state.model)
    train["step_time"] = phase_step_time(torch, cfg, trainer, state, train_c)
    print("train:", json.dumps(train))
    t_stage = time.perf_counter()
    closure = phase_large_closure(torch)
    stage = phase_search_stage(torch, cfg, scorer, dataset, state.model, test_c)
    stage["large_closure"] = closure
    stage["seconds"] = time.perf_counter() - t_stage
    print("search_stage:", json.dumps(stage))
    t_pipe = time.perf_counter()
    pipeline = phase_pipeline(torch, cfg, name, corpus, train_c, test_c,
                              stage["steps"]["hill_climb"]["best_bic_exact"])
    pipeline["seconds"] = time.perf_counter() - t_pipe
    print("pipeline:", json.dumps(pipeline))
    launches_by_path = {
        "search": search["kernel_launches"],
        "train_chunked": train["chunked"]["launches"],
        "train_per_step": train["per_step"]["launches"],
        "train_search": train["search"]["kernel_launches"],
        **{f"stage_{name}": info["launches"] for name, info in stage["steps"].items()},
        **{f"pipeline_{name}": info["launches"] for name, info in pipeline["stages"].items()},
    }
    # rows of 512 bins: the narrow score, fused and family kernels ran, no
    # path called the seg entry, and no wide kernel ran
    narrow_total = {k: sum(p[k] for p in launches_by_path.values()) for k in KERNELS}
    narrow_paths = ("node_scores_fused", "contingency_counts_fused", "contingency_counts_family")
    check(all(narrow_total[k] > 0 for k in narrow_paths)
          and sum(narrow_total.values()) == sum(narrow_total[k] for k in narrow_paths),
          f"phases 1-10 launches {narrow_total}")

    t_wide = time.perf_counter()
    wide = phase_wide_rows(torch, scorer)
    wide["seconds"] = time.perf_counter() - t_wide
    print(f"wide_rows ({nvidia_smi('name,power.limit')}):", json.dumps(wide))
    launches_by_path.update({f"wide_{k}": v["launches"] for k, v in wide["steps"].items()})
    t_codec = time.perf_counter()
    codec = phase_native_codec()
    codec["seconds"] = time.perf_counter() - t_codec
    print("native_codec:", json.dumps(codec))
    t_dp = time.perf_counter()
    parallel = phase_data_parallel(torch, cfg, train_c, dataset)
    parallel["seconds"] = time.perf_counter() - t_dp
    print("data_parallel (one card, no multi-card number):", json.dumps(parallel))
    t_tier = time.perf_counter()
    tier = phase_tier(torch, REGISTRY[TIER_NAME])
    tier["seconds"] = time.perf_counter() - t_tier
    print(f"tier ({nvidia_smi('name,power.limit')}):", json.dumps(tier))
    launches_by_path.update({f"tier_{k}": v["launches"] for k, v in tier["search"].items()})
    t_small = time.perf_counter()
    small = phase_small_tier(torch)
    small["seconds"] = time.perf_counter() - t_small
    print(f"small_tier ({nvidia_smi('name,power.limit')}):", json.dumps(small))
    launches_by_path.update({f"small_{k}": v["launches"] for k, v in small["steps"].items()})
    t_large = time.perf_counter()
    large = phase_large_tier(torch)
    large["seconds"] = time.perf_counter() - t_large
    print(f"large_tier ({nvidia_smi('name,power.limit')}):", json.dumps(large))
    launches_by_path.update({k: v["launches"] for k, v in large["steps"].items()})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernel_records(search, er, decoded, stage, wide, tier, small,
                                                large, sweep, launches_by_path)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
