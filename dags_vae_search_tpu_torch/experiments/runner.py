"""Experiment pipeline runner + CLI (torch).

Counterpart of ``dags_vae_search_tpu/experiments/runner.py``.  Every stage
is a subcommand over a named config:

    python -m dags_vae_search_tpu_torch.experiments.runner asia generate split train
    python -m dags_vae_search_tpu_torch.experiments.runner asia eval search --epoch 100

Stages:
  generate  — curriculum ER corpus -> npz parts
  split     — seeded train/test split
  train     — VAE training with epoch checkpoints
  eval      — reconstruction metrics
  predictor — latent/BIC pairs dataset
  gp        — GP surrogate fit + MAE/MAPE report
  search    — latent + structure search for best BIC
  roundtrip — encode -> GP-predict -> decode -> compare
  viz       — the three-panel demo figure (needs matplotlib)

Artifacts land under ``<data_dir>/<experiment>/``: corpus npz parts,
checkpoints, the predictor set and stage reports as JSON.  Every report is
mirrored into a ``reports_torch/`` sibling of the data dir, and names the
device it ran on.  Everything runs on ``--device`` (default ``cuda``).

The eval stage's default for up to 128 vertices counts structure matches by
networkx isomorphism; where networkx is not installed, pass
``use_isomorphism=False`` (exact slot-wise equality), or the stage raises
``ImportError``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import time
from typing import Optional

import numpy as np
import torch


def device_label(device: torch.device) -> str:
    """``"cpu"``, or the card's name and power limit as ``nvidia-smi``
    prints them (``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        limit = smi.stdout.strip() if smi.returncode == 0 else "power limit not read"
    except (OSError, subprocess.TimeoutExpired):
        limit = "power limit not read"
    return f"{name}, {limit}"


class ExperimentRunner:
    def __init__(
        self,
        config,
        data_dir: Optional[str] = None,
        variant: Optional[str] = None,
        device="cuda",
    ):
        self.config = config
        self.device = torch.device(device)
        base = os.path.join(data_dir or config.data_dir, config.name)
        # A variant writes its artifacts under <exp>@<variant> but reads
        # shared inputs (corpus, splits, simulated dataset) from the base
        # experiment when it has not produced its own.
        self.base_root = base
        self.root = f"{base}@{variant}" if variant else base
        os.makedirs(self.root, exist_ok=True)
        # Every report is mirrored into a reports_torch/ SIBLING of the runs
        # dir, so wiping the runs dir keeps the results; never into the
        # JAX package's reports/, which holds its own runs.
        runs_dir = os.path.dirname(os.path.abspath(base))
        self.reports_root = os.path.join(
            os.path.dirname(runs_dir), "reports_torch", os.path.basename(self.root)
        )
        self._device_label = None
        self._model = None
        self._dataset = None
        self._truth_adj = None

    # ------------------------------------------------------------- plumbing

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def data_path(self, *parts: str) -> str:
        """Variant-local path if present, else the base experiment's."""
        local = os.path.join(self.root, *parts)
        if os.path.exists(local) or self.root == self.base_root:
            return local
        shared = os.path.join(self.base_root, *parts)
        return shared if os.path.exists(shared) else local

    def report(self, stage: str, payload: dict) -> None:
        if self._device_label is None:
            self._device_label = device_label(self.device)
        payload = {"stage": stage, "time": time.time(), "device": self._device_label, **payload}
        blob = json.dumps(payload, indent=2, default=float)
        for root in (self.root, self.reports_root):
            os.makedirs(root, exist_ok=True)
            with open(os.path.join(root, f"report_{stage}.json"), "w") as fh:
                fh.write(blob)
        print(f"[{self.config.name}:{stage}] " + json.dumps(payload, default=float))

    @property
    def model(self):
        if self._model is None:
            from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE

            self._model = PaceVAE(**self.config.model_kwargs()).to(self.device)
        return self._model

    def scoring_dataset(self):
        """The discrete dataset scored against (real target.csv or simulated
        ground truth, persisted for reproducibility)."""
        if self._dataset is not None:
            return self._dataset
        from dags_vae_search_tpu_torch.graphs import sampler
        from dags_vae_search_tpu_torch.scoring import catalog
        from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset, load_target_csv

        if self.config.dataset_csv:
            self._dataset = load_target_csv(self.config.dataset_csv)
            return self._dataset

        sim_codes = self.data_path("simulated_codes.npz")
        if os.path.exists(sim_codes):
            with np.load(sim_codes) as blob:
                codes, cards, truth = blob["codes"], blob["cards"], blob["truth_adj"]
            self._dataset = DiscreteDataset(
                codes=codes, cards=cards, columns=[f"x{i}" for i in range(codes.shape[1])]
            )
            self._truth_adj = truth
            return self._dataset

        rng = np.random.default_rng(self.config.seed)
        n = self.config.num_vertices
        entry = catalog.CATALOG.get(self.config.name)
        num_edges = entry.num_edges if entry else 2 * n
        try:
            _, adj = sampler.sample_er_batch(rng, 1, n, num_edges, n)
        except RuntimeError:
            # rejection sampling of a connected ER DAG is hopeless near the
            # connectivity threshold at large n (andes n=223, link n=724):
            # the constructive sampler the corpus generator uses above n=64
            _, adj = sampler.sample_connected_dags(rng, 1, n, num_edges, n)
        truth = adj[0]
        cards = rng.integers(2, self.config.simulate_max_card + 1, size=n)
        dataset = catalog.simulate_dataset(rng, truth, cards, self.config.simulate_cases)
        np.savez(sim_codes, codes=dataset.codes, cards=dataset.cards, truth_adj=truth)
        self._dataset = dataset
        self._truth_adj = truth
        return dataset

    def scorer(self):
        from dags_vae_search_tpu_torch.scoring.bic import BicScorer

        return BicScorer(
            self.scoring_dataset(), max_parents=self.config.search.max_parents,
            device=self.device,
        )

    def load_state(self, epoch: Optional[int] = None) -> int:
        """Load checkpoint ``epoch`` (the latest when None) into
        :attr:`model`; returns the epoch."""
        from dags_vae_search_tpu_torch.training import checkpoint as ckpt

        ckpt_dir = self.path("checkpoints")
        if epoch is None:
            epoch = ckpt.latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        model = self.model
        model.load_state_dict(ckpt.restore_params(ckpt_dir, epoch, model.state_dict()))
        return epoch

    def _load_corpus(self, split: str):
        from dags_vae_search_tpu_torch.training import data as data_lib

        return data_lib.load_corpus(self.data_path(split))

    def _to_columns(self, labels: np.ndarray, adj: np.ndarray) -> np.ndarray:
        """Graph -> dataset-column space (identity for unlabeled corpora)."""
        adj = np.asarray(adj)
        if self.config.label_cardinality == 1:
            return adj
        out = np.zeros_like(adj)
        perm = np.asarray(labels)
        out[np.ix_(perm, perm)] = adj
        return out

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    # --------------------------------------------------------------- stages

    def stage_generate(self) -> None:
        from dags_vae_search_tpu_torch.graphs import codec, sampler

        c = self.config.corpus
        rng = np.random.default_rng(self.config.seed)
        t0 = time.time()
        labels, adj = sampler.generate_corpus(
            rng, self.config.num_vertices, self.config.label_cardinality, c.batch_size,
            c.steps_limit, c.density_limit, c.label_method, max_in_degree=c.max_in_degree,
        )
        codec.write_dataset(self.path("corpus"), labels, adj)
        self.report("generate", {
            "rows": int(labels.shape[0]),
            "seconds": time.time() - t0,
            "graphs_per_second": labels.shape[0] / (time.time() - t0),
        })

    def stage_split(self) -> None:
        from dags_vae_search_tpu_torch.graphs import codec
        from dags_vae_search_tpu_torch.training import data as data_lib

        corpus = self._load_corpus("corpus")
        train, test = data_lib.train_test_split(
            corpus, self.config.corpus.test_ratio, self.config.seed
        )
        codec.write_corpus(self.path("train"), train)
        codec.write_corpus(self.path("test"), test)
        self.report("split", {"train_rows": len(train), "test_rows": len(test)})

    def stage_train(self, epochs: Optional[int] = None, resume: bool = False) -> None:
        from dags_vae_search_tpu_torch.training import checkpoint as ckpt
        from dags_vae_search_tpu_torch.training.train import Trainer

        corpus = self._load_corpus("train")
        trainer = Trainer(self.model, self.config.train)
        state = trainer.init_state(self.config.seed)
        ckpt_dir = self.path("checkpoints")
        start_epoch = 1
        if resume:
            latest = ckpt.latest_epoch(ckpt_dir)
            if latest is not None:
                model = state.model
                model.load_state_dict(ckpt.restore_params(ckpt_dir, latest, model.state_dict()))
                start_epoch = latest + 1
        else:
            # Fresh run: clear stale checkpoints — a previous run's higher
            # epoch numbers (possibly under a different ModelConfig) would
            # otherwise shadow this run's checkpoints at load_state time.
            shutil.rmtree(ckpt_dir, ignore_errors=True)

        def save(epoch, st):
            ckpt.save_checkpoint(ckpt_dir, epoch, {"params": st.model.state_dict()})

        state, history = trainer.fit(
            state, corpus, epochs=epochs, start_epoch=start_epoch, checkpoint_fn=save
        )
        self.report("train", {
            "epochs": len(history),
            "final": history[-1] if history else None,
            "history": history,
        })

    def stage_eval(
        self,
        epoch: Optional[int] = None,
        max_batches: Optional[int] = 20,
        use_isomorphism: Optional[bool] = None,
    ) -> None:
        from dags_vae_search_tpu_torch.training import eval as eval_lib

        if use_isomorphism is None:
            # networkx VF2 on 200+-node digraphs can take minutes per graph;
            # exact slot-wise equality is the operative criterion anyway
            # (decoded graphs come back in the encoding's vertex order).
            use_isomorphism = self.config.num_vertices <= 128
        epoch = self.load_state(epoch)
        metrics = eval_lib.evaluate_corpus(
            self.model, self._load_corpus("test"), self.config.train.batch_size,
            seed=self.config.seed + 1, max_batches=max_batches,
            use_isomorphism=use_isomorphism,
        )
        self.report("eval", {"epoch": epoch, **metrics})

    def stage_predictor(self, epoch: Optional[int] = None, max_rows: int = 4096) -> None:
        from dags_vae_search_tpu_torch.surrogate import dataset as sur_dataset

        epoch = self.load_state(epoch)
        corpus = self._load_corpus("test")
        rows = min(max_rows, len(corpus))
        vectors, targets = sur_dataset.build_predictor_dataset(
            self.model, self.scorer(), corpus.labels[:rows], corpus.dense_batch(np.arange(rows))
        )
        sur_dataset.write_predictor_dataset(self.path("predictor_dataset"), vectors, targets)
        self.report("predictor", {
            "epoch": epoch,
            "rows": int(rows),
            "finite_fraction": float(np.isfinite(targets).mean()),
        })

    def stage_gp(self, train_fraction: float = 0.8) -> None:
        from dags_vae_search_tpu_torch.surrogate import dataset as sur_dataset
        from dags_vae_search_tpu_torch.surrogate.gp import SGPR, ExactGP

        vectors, targets = sur_dataset.read_predictor_dataset(self.path("predictor_dataset"))
        keep = np.isfinite(targets)
        vectors, targets = vectors[keep], targets[keep]
        n_train = int(len(vectors) * train_fraction)
        model_cls = ExactGP if n_train <= 6000 else SGPR
        gp = model_cls(device=self.device).fit(
            vectors[:n_train], targets[:n_train], iters=self.config.search.gp_iters
        )
        pred = gp.predict(vectors[n_train:])
        self.report("gp", {
            "model": model_cls.__name__,
            "train_points": n_train,
            "test_points": len(vectors) - n_train,
            "mae": float(np.abs(pred - targets[n_train:]).mean()),
            "mape": float(np.abs((pred - targets[n_train:]) / targets[n_train:]).mean()),
        })

    def stage_search(self, epoch: Optional[int] = None) -> None:
        from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
        from dags_vae_search_tpu_torch.search import hillclimb
        from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb

        scorer = self.scorer()
        cfg = self.config.search
        result_payload = {}

        # For small nets the family table makes move scoring a pure gather.
        n_vars = self.scoring_dataset().num_variables
        if n_vars <= 16:
            from dags_vae_search_tpu_torch.scoring.family_table import FamilyTableScorer

            fast_scorer = FamilyTableScorer(
                self.scoring_dataset(), max_parents=cfg.max_parents, base_scorer=scorer
            )
        else:
            fast_scorer = scorer

        # Certified optimum via subset DP when tractable.
        if n_vars <= 18:
            from dags_vae_search_tpu_torch.search import exact

            t0 = time.time()
            opt = exact.exact_search(scorer, n_vars, max_parents=min(cfg.max_parents or 4, 6))
            result_payload["exact_optimum"] = {
                "best_bic": float(scorer.score_exact(opt.best_adj[None])[0]),
                "families": opt.num_families,
                "seconds": time.time() - t0,
            }

        # Structure space: greedy hill climbing (certified local optimum).
        # Dense batched moves up to mid n; family-delta climbing beyond (the
        # dense candidate tensors are O(n^4)).
        use_delta = n_vars > 48
        fam_scorer = FamilyBatchScorer(
            self.scoring_dataset(), max_parents=cfg.max_parents or 8, q_cap=scorer.q_cap,
            device=self.device,
        )
        # The per-climb wall budget divides across the basin-hopping
        # restarts so the whole stage stays within hill_climb_time_s.
        n_climbs = 1 + max(cfg.hill_climb_restarts, 0)
        per_climb_time = (
            cfg.hill_climb_time_s / n_climbs if cfg.hill_climb_time_s is not None else None
        )

        def climb(init_adj=None, max_iters=None, time_s=per_climb_time):
            if use_delta:
                return delta_hill_climb(
                    fam_scorer, n_vars, init_adj=init_adj,
                    max_iters=max_iters or max(cfg.hill_climb_iters, 4 * n_vars),
                    time_budget_s=time_s, accept_batch=cfg.hill_climb_accept_batch,
                )
            return hillclimb.hill_climb(
                fast_scorer, n_vars, init_adj=init_adj, max_iters=max_iters or cfg.hill_climb_iters
            )

        t0 = time.time()
        hc = hillclimb.climb_with_restarts(
            climb, np.random.default_rng(self.config.seed + 11),
            restarts=max(cfg.hill_climb_restarts, 0), max_parents=cfg.max_parents,
            tie_stop=cfg.hill_climb_tie_stop,
        )
        hc_seconds = time.time() - t0
        result_payload["hill_climb"] = {
            "best_bic": float(scorer.score_exact(hc.best_adj[None])[0]),
            "iterations": hc.iterations,
            "evals": hc.num_evals,
            "seconds": hc_seconds,
            "evals_per_sec": hc.num_evals / max(hc_seconds, 1e-9),
            "impl": "delta" if use_delta else "dense",
            "restarts": max(cfg.hill_climb_restarts, 0),
            "restart_history": [float(x) for x in hc.history[-n_climbs:]],
            "converged": bool(hc.converged),
            **({"profile": hc.profile} if hc.profile else {}),
        }

        try:
            self._search_latent(epoch, scorer, fast_scorer, climb, hc, n_vars, result_payload)
        except FileNotFoundError:
            result_payload["island_cem"] = "skipped (no checkpoint)"
        except Exception as exc:  # noqa: BLE001 — keep the structure-space
            # results: a latent-stage failure (e.g. a checkpoint trained
            # under a different ModelConfig) must not lose the hill-climb /
            # exact report.
            import traceback

            traceback.print_exc()
            result_payload.setdefault(
                "island_cem", "skipped ({}: {})".format(type(exc).__name__, str(exc)[:200])
            )

        if self._truth_adj is not None:
            result_payload["ground_truth_bic"] = float(scorer.score_exact(self._truth_adj[None])[0])
        self.report("search", result_payload)

    def _search_latent(self, epoch, scorer, fast_scorer, climb, hc, n_vars, result_payload):
        """The latent half of :meth:`stage_search`: island CEM through the
        trained decoder, seeded from encoded corpus latents (the VAE's latent
        marginal is far from N(0,1) at beta=0.005/eps=0.01, so prior samples
        decode to junk), its polish climb, refine, GP ascent, BO and the
        fixed-budget comparison; each adds its entry to ``result_payload``."""
        from dags_vae_search_tpu_torch.scoring.bic import relabel_to_columns
        from dags_vae_search_tpu_torch.search import islands
        from dags_vae_search_tpu_torch.search import latent as latent_mod

        cfg = self.config.search
        epoch = self.load_state(epoch)
        model, dev, seed = self.model, self.device, self.config.seed
        test_corpus = self._load_corpus("test")
        seed_n = min(2048, len(test_corpus))
        seed_labels = test_corpus.labels[:seed_n]
        seed_adj = test_corpus.dense_batch(np.arange(seed_n))
        mus = latent_mod.encode_mu(model, self._tensor(seed_labels), self._tensor(seed_adj))
        init_sigma = float(mus.std(dim=0, correction=0).mean())

        # Corpus-elite seeding: islands start from the latents of the
        # best-scoring corpus graphs (by real BIC), cold with respect to the
        # discrete search (the hill-climb winner's encoding is not used here;
        # it powers the explicitly hybrid refine, GP ascent and BO).
        if self.config.label_cardinality == 1:
            seed_cols = self._tensor(seed_adj)
        else:
            seed_cols = relabel_to_columns(self._tensor(seed_labels), self._tensor(seed_adj))
        # 256-graph chunks bound the contingency intermediates of the seed
        # scoring (B * n * q_cap counts per call).
        seed_scores = np.concatenate([
            fast_scorer.score(seed_cols[s : s + 256]).cpu().numpy()
            for s in range(0, len(seed_cols), 256)
        ])
        elite_pick = np.argsort(-seed_scores)[: cfg.islands]
        # PCA subspace for the cold CEM: the top-k principal coordinates of
        # the corpus latents (the decoder's data manifold) instead of all of z.
        mus_np = mus.cpu().numpy()
        k_sub = (
            int(min(cfg.island_subspace, mus_np.shape[1], len(mus_np) - 1))
            if cfg.island_subspace else 0
        )
        if k_sub > 0:
            z_center = mus_np.mean(axis=0)
            _, _, vt = np.linalg.svd(mus_np - z_center, full_matrices=False)
            z_basis = vt[:k_sub]
            coords = (mus_np - z_center) @ z_basis.T
            sigma_vec = coords.std(axis=0) + 1e-6
            init_means = coords[elite_pick]
            cem_space = dict(basis=z_basis, center=z_center, init_sigma=sigma_vec,
                             sigma_floor=sigma_vec * 0.05)
        else:
            init_means = mus_np[elite_pick]
            cem_space = dict(init_sigma=init_sigma, sigma_floor=init_sigma * 0.05)
        hc_labels, hc_adj = latent_mod.column_adj_to_labeled(
            hc.best_adj, np.random.default_rng(seed + 7)
        )
        hc_mu = latent_mod.encode_mu(
            model, self._tensor(hc_labels[None]), self._tensor(hc_adj[None])
        ).cpu().numpy()

        def exact_of(res_):
            if not np.isfinite(res_.best_score):
                return None
            cols = self._to_columns(res_.best_labels, res_.best_adj)
            return float(scorer.score_exact(cols[None])[0])

        def latent_entry(res_, t0, **extra):
            entry = {"best_bic": res_.best_score, "evals": res_.num_evals,
                     "seconds": time.time() - t0, **extra}
            if np.isfinite(res_.best_score):
                entry["best_bic_exact"] = exact_of(res_)
            return entry

        t0 = time.time()
        res = islands.island_cem_search(
            model, fast_scorer, seed=seed + 2, num_islands=cfg.islands,
            population=cfg.island_population, iters=cfg.island_iters, init_means=init_means,
            device=dev, **cem_space,
        )
        # cold: seeded from corpus elites only, never from the discrete
        # search's winner
        result_payload["island_cem"] = latent_entry(res, t0, epoch=epoch, subspace=k_sub,
                                                    cold=True)

        # Latent proposes, discrete polishes: a greedy climb from the island
        # winner's structure certifies the local optimum in its basin.
        if np.isfinite(res.best_score):
            t0 = time.time()
            polish = climb(init_adj=self._to_columns(res.best_labels, res.best_adj))
            result_payload["island_cem_polished"] = {
                "best_bic": float(scorer.score_exact(polish.best_adj[None])[0]),
                "iterations": polish.iterations,
                "evals": polish.num_evals,
                "seconds": time.time() - t0,
            }

        # Hybrid: local latent refinement around the hill-climb winner,
        # encoded under several random topological orders (labels must look
        # like the corpus's independent permutations).
        order_rng = np.random.default_rng(seed + 5)
        anchor_pairs = [latent_mod.column_adj_to_labeled(hc.best_adj, order_rng) for _ in range(8)]
        t0 = time.time()
        refined = latent_mod.refine_search(
            model, fast_scorer, np.stack([p[0] for p in anchor_pairs]),
            np.stack([p[1] for p in anchor_pairs]), seed=seed + 3, iters=cfg.refine_iters,
            population=cfg.refine_population, device=dev,
        )
        result_payload["latent_refined"] = latent_entry(refined, t0)

        # Surrogate-guided: GP posterior-UCB ascent over z from the best
        # predictor latents, then the closed BO loop.
        predictor_path = self.path("predictor_dataset")
        if not os.path.isdir(predictor_path):
            return
        from dags_vae_search_tpu_torch.surrogate import dataset as sur_ds
        from dags_vae_search_tpu_torch.surrogate.gp import ExactGP

        vectors, targets = sur_ds.read_predictor_dataset(predictor_path)
        keep = np.isfinite(targets)
        vectors, targets = vectors[keep], targets[keep]
        order = np.argsort(-targets)
        gp = ExactGP(device=dev).fit(vectors[:3000], targets[:3000], iters=cfg.gp_iters)
        # Seeds: the hill-climb winner's encoding, the island-CEM incumbent,
        # then the top predictor-corpus latents; GP ascent also scores the
        # un-moved seeds.
        n_seed = cfg.gp_ascent_seeds
        extra = [hc_mu]
        if np.isfinite(res.best_score):
            extra.append(res.best_z[None])
        z_init = np.concatenate(extra + [vectors[order[: n_seed - 2]]])[:n_seed]
        t0 = time.time()
        asc = latent_mod.gp_ascent_search(
            model, fast_scorer, gp, seed + 4, z_init, steps=100, ucb_beta=0.5,
            decode_rounds=cfg.gp_ascent_rounds, device=dev,
        )
        result_payload["gp_ascent"] = latent_entry(asc, t0)

        # Closed-loop BO: fit -> ascend UCB -> decode+score -> append ->
        # refit, seeded as GP ascent and warm-started with the predictor set
        # as GP observations.
        t0 = time.time()
        bo = latent_mod.bo_search(
            model, fast_scorer, seed + 6, z_init, extra_obs=(vectors[:3000], targets[:3000]),
            rounds=cfg.bo_rounds, ucb_beta=1.0, gp_iters=min(cfg.gp_iters, 200),
            acq_pool=4096, device=dev,
        )
        result_payload["bo"] = latent_entry(bo, t0)

        # Sample efficiency: BO vs GP ascent vs cold island CEM at the same
        # small budget of real decode+score evals, seeded identically with
        # the top predictor-corpus latents (no hill-climb anchor).
        if not (cfg.budget_compare_evals and n_vars <= 48):
            return
        budget = int(cfg.budget_compare_evals)
        s_n = max(budget // 4, 8)
        cold_seed = vectors[order[:s_n]]
        comp = {"budget_evals": budget}
        t0 = time.time()
        r_asc = latent_mod.gp_ascent_search(
            model, fast_scorer, gp, seed + 8, cold_seed, steps=100, ucb_beta=0.5,
            decode_rounds=budget // s_n - 1, device=dev,
        )
        comp["gp_ascent"] = {"best_bic_exact": exact_of(r_asc), "evals": r_asc.num_evals,
                             "seconds": time.time() - t0}
        t0 = time.time()
        r_bo = latent_mod.bo_search(
            model, fast_scorer, seed + 9, cold_seed, extra_obs=(vectors[:3000], targets[:3000]),
            rounds=budget // s_n - 1, ucb_beta=1.0, gp_iters=min(cfg.gp_iters, 200),
            acq_pool=4096, device=dev,
        )
        comp["bo"] = {"best_bic_exact": exact_of(r_bo), "evals": r_bo.num_evals,
                      "seconds": time.time() - t0}
        n_isl = min(4, cfg.islands)
        pop = max(s_n // n_isl, 8)
        it_cem = max((budget - s_n) // (n_isl * pop), 1)
        comp_means = coords[elite_pick[:n_isl]] if k_sub > 0 else mus_np[elite_pick[:n_isl]]
        t0 = time.time()
        r_cem = islands.island_cem_search(
            model, fast_scorer, seed=seed + 10, num_islands=n_isl, population=pop,
            iters=it_cem, init_means=comp_means,
            exploit_repeats=max((budget - n_isl * pop * it_cem) // n_isl, 0), device=dev,
            **cem_space,
        )
        comp["island_cem"] = {"best_bic_exact": exact_of(r_cem), "evals": r_cem.num_evals,
                              "seconds": time.time() - t0}
        finite = {
            k: v["best_bic_exact"] for k, v in comp.items()
            if isinstance(v, dict) and v.get("best_bic_exact") is not None
        }
        if finite:
            comp["winner"] = max(finite, key=finite.get)
        result_payload["budget_comparison"] = comp

    def stage_viz(self, epoch: Optional[int] = None) -> None:
        """The demo figure: a test-corpus graph as original / PACE-wrapped /
        decoded panels -> <root>/demo.png (needs matplotlib)."""
        from dags_vae_search_tpu_torch.utils import viz

        epoch = self.load_state(epoch)
        corpus = self._load_corpus("test")
        out = viz.draw_examples(
            self.model, corpus.labels[:1], corpus.dense_batch(np.arange(1)),
            out_path=self.path("demo.png"),
        )
        self.report("viz", {"epoch": epoch, "figure": out})

    def stage_roundtrip(self, epoch: Optional[int] = None) -> None:
        """Encode a test graph, GP-predict its BIC, decode it back, compare."""
        from dags_vae_search_tpu_torch.graphs.dag import graphs_equal_exact
        from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
        from dags_vae_search_tpu_torch.scoring.bic import BicScorer
        from dags_vae_search_tpu_torch.search.latent import encode_mu
        from dags_vae_search_tpu_torch.surrogate import dataset as sur_dataset
        from dags_vae_search_tpu_torch.surrogate.gp import ExactGP

        epoch = self.load_state(epoch)
        corpus = self._load_corpus("test")
        labels, adj = corpus.labels[:1], corpus.dense_batch(np.arange(1))
        lb, ad = self._tensor(labels), self._tensor(adj)
        mu = encode_mu(self.model, lb, ad)
        # Cap-free exact scoring: dense corpus graphs (e.g. alarm in-degree
        # > 12) blow past any dense-contingency q_cap, so the sparse host
        # scorer, finite for any in-degree.
        scorer = BicScorer(self.scoring_dataset(), device=self.device)
        true_bic = float(scorer.score_exact_sparse(self._to_columns(labels[0], adj[0])[None])[0])

        vectors, targets = sur_dataset.read_predictor_dataset(self.path("predictor_dataset"))
        keep = np.isfinite(targets)
        gp = ExactGP(device=self.device).fit(
            vectors[keep][:4000], targets[keep][:4000], iters=self.config.search.gp_iters
        )
        predicted = float(gp.predict(mu.cpu().numpy())[0])

        recon, valid = decode_to_labeled(
            self.model, mu, torch.Generator(device=self.device).manual_seed(7)
        )
        equal = bool(graphs_equal_exact(lb, ad, recon.labels, recon.adj)[0])
        self.report("roundtrip", {
            "epoch": epoch,
            "true_bic": true_bic,
            "gp_predicted_bic": predicted,
            "relative_error": abs(predicted - true_bic) / abs(true_bic),
            "decode_valid": bool(valid[0]),
            "decode_equal": equal,
        })


STAGES = (
    "generate",
    "split",
    "train",
    "eval",
    "predictor",
    "gp",
    "search",
    "roundtrip",
    "viz",
)


def main(argv=None):
    from dags_vae_search_tpu_torch.experiments.registry import REGISTRY

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("experiment", choices=sorted(REGISTRY))
    parser.add_argument("stages", nargs="+", choices=STAGES)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device every stage runs on (default cuda)")
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--batch-size", type=int, default=None)
    # model/optimizer overrides for capacity/schedule sweeps; a non-empty
    # --variant redirects reports+checkpoints to <data-dir>/<exp>@<variant>
    # (sharing the base experiment's corpus) so sweeps never clobber the
    # canonical run.
    parser.add_argument("--variant", default=None)
    parser.add_argument("--embed-size", type=int, default=None)
    parser.add_argument("--num-heads", type=int, default=None)
    parser.add_argument("--num-layers", type=int, default=None)
    parser.add_argument("--latent-size", type=int, default=None)
    parser.add_argument("--fc-hidden", type=int, default=None)
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--edge-readout", action="store_true", default=None)
    parser.add_argument("--edge-readout-rank", type=int, default=None)
    parser.add_argument("--matmul-dtype", default=None,
                        help="e.g. bfloat16 (operands rounded to it, float32 accumulation)")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr-schedule", choices=["plateau", "cosine"], default=None)
    parser.add_argument("--warmup-epochs", type=int, default=None)
    parser.add_argument("--steps-per-call", type=int, default=None)
    # search-budget overrides (the registry defaults size the anytime hill
    # climb for a full production run; these bound a quick pass)
    parser.add_argument("--hc-time", type=float, default=None,
                        help="hill-climb wall-clock budget in seconds")
    parser.add_argument("--hc-iters", type=int, default=None,
                        help="hill-climb max accepted-move count")
    parser.add_argument("--eval-batches", type=int, default=None,
                        help="cap the eval stage at this many test batches")
    args = parser.parse_args(argv)

    # a copy: the overrides below must not change the shared registry
    config = copy.deepcopy(REGISTRY[args.experiment])
    if args.batch_size:
        config.train.batch_size = args.batch_size
    for field_name, arg in (
        ("embed_size", args.embed_size),
        ("num_heads", args.num_heads),
        ("num_layers", args.num_layers),
        ("latent_size", args.latent_size),
        ("fc_hidden", args.fc_hidden),
        ("dropout", args.dropout),
        ("edge_readout", args.edge_readout),
        ("edge_readout_rank", args.edge_readout_rank),
        ("matmul_dtype", args.matmul_dtype),
    ):
        if arg is not None:
            setattr(config.model, field_name, arg)
    for field_name, arg in (
        ("learning_rate", args.lr),
        ("lr_schedule", args.lr_schedule),
        ("warmup_epochs", args.warmup_epochs),
        ("steps_per_call", args.steps_per_call),
    ):
        if arg is not None:
            setattr(config.train, field_name, arg)
    if args.hc_time is not None:
        config.search.hill_climb_time_s = args.hc_time
    if args.hc_iters is not None:
        config.search.hill_climb_iters = args.hc_iters
    runner = ExperimentRunner(config, data_dir=args.data_dir, variant=args.variant,
                              device=args.device)
    for stage in args.stages:
        if stage == "train":
            runner.stage_train(epochs=args.epochs, resume=args.resume)
        elif stage == "eval":
            kwargs = {"epoch": args.epoch}
            if args.eval_batches is not None:
                kwargs["max_batches"] = args.eval_batches
            runner.stage_eval(**kwargs)
        elif stage in ("predictor", "search", "roundtrip", "viz"):
            getattr(runner, f"stage_{stage}")(epoch=args.epoch)
        else:
            getattr(runner, f"stage_{stage}")()


if __name__ == "__main__":
    main()
