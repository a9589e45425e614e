"""Training the VAE: ``training/train.py::Trainer.chunk_step`` on a corpus
held on the device as ``Trainer.fit`` holds it (bit-packed above 64
vertices), batches of the configuration's size drawn without repeats within
a pass over the corpus.

Set-up builds the trainer and its state and drives them through their first
three steps by the same call the window makes (one step, then two), on rows
that all differ: the loss of each, the first gradient as Adam received it
(its first moment after one step over 1 - beta1) and the weights after the
three are kept for the check, and the steps warm every shape.  A unit is
one chunk of ``steps_per_call`` steps, read back once; its work is the
graphs it trained on.  The window's first chunk keeps its rows and losses.

Checked against the reference, which follows the same three steps from the
same weights, batches and dropout stream: each step's loss, the first
gradient's norm leaf by leaf, and the norm of each leaf's change over the
three steps.  Then, from the program's weights and Adam moments after the
three, the first three steps of the window's first chunk: their losses.
(Over a whole chunk float32 rounding alone grows to the size of the TF32
control's gap, so the chunk's later steps cannot be judged.)
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import common, inputs
from h100_bench.reference import pace as ref_pace

CHECKED_STEPS = 3


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int, device):
        from dags_vae_search_tpu_torch.training import data as data_lib
        from dags_vae_search_tpu_torch.training.train import TrainConfig, Trainer, TrainState

        self.cfg, self.params, self.seed, self.device = cfg, params, seed, device
        self.counts: dict = {}
        t = cfg["train"]
        self.batch = t["batch_size"]
        self.steps = t["steps_per_call"]
        self.lr = t["learning_rate"] / t["warmup_epochs"]  # the schedule's first epoch
        self.labels, self.adj = inputs.corpus(
            inputs.rng_for(seed, "corpus"), cfg["num_vertices"], cfg["corpus"]["graphs"],
            cfg["corpus"]["density_limit"], cfg["corpus"]["max_in_degree"])
        self.weights = common.make_weights(cfg, seed, device)
        model = common.program_model(cfg, self.weights, device)
        self.trainer = Trainer(model, TrainConfig(
            batch_size=self.batch, learning_rate=self.lr, clip_norm=t["clip_norm"],
            steps_per_call=self.steps))
        self.state = TrainState(model, self.trainer.make_optimizer(model), 0)
        corpus = data_lib.pack_corpus(self.labels, self.adj)
        self.corpus_labels, self.corpus_adj = self.trainer.corpus_to_device(
            corpus, torch.device(device), log=lambda line: None)
        self.order = inputs.rng_for(seed, "batches")
        self.queue = np.empty(0, dtype=np.int64)
        self.gen_seed = common.torch_seed(seed, "dropout")
        self.gen = torch.Generator(device=device).manual_seed(self.gen_seed)

        # the first three steps: one, then two, through the window's call
        self.first_rows = self._rows(CHECKED_STEPS)
        self.chunk = None  # (rows, losses) of the window's first chunk
        params = [p for p in model.parameters()]
        names = [n for n, _ in model.named_parameters()]
        self.p0 = {n: p.detach().cpu().clone() for n, p in zip(names, params)}
        l1 = self._chunk(self.first_rows[:1])
        beta1 = self.state.optimizer.defaults["betas"][0]
        moments = self.state.optimizer.state
        self.g1 = {n: (moments[p]["exp_avg"] / (1 - beta1)).cpu() if "exp_avg" in moments[p]
                   else torch.zeros_like(p, device="cpu") for n, p in zip(names, params)}
        l23 = self._chunk(self.first_rows[1:])
        self.losses = torch.cat([l1, l23]).cpu()
        self.p3 = {n: p.detach().cpu().clone() for n, p in zip(names, params)}
        # Adam's state after the three, where the window's first chunk starts
        def moment(p, key):
            return (moments[p][key].detach().cpu().clone() if key in moments[p]
                    else torch.zeros_like(p, device="cpu"))

        self.moments3 = ({n: moment(p, "exp_avg") for n, p in zip(names, params)},
                         {n: moment(p, "exp_avg_sq") for n, p in zip(names, params)},
                         CHECKED_STEPS)

    def _rows(self, steps: int) -> np.ndarray:
        """The next ``steps`` batches of corpus rows, passes over the corpus
        in seed-drawn orders."""
        need = steps * self.batch
        while self.queue.size < need:
            self.queue = np.concatenate([self.queue, self.order.permutation(len(self.labels))])
        rows, self.queue = self.queue[:need], self.queue[need:]
        return rows.reshape(steps, self.batch)

    def _chunk(self, rows: np.ndarray) -> torch.Tensor:
        block = torch.as_tensor(rows, device=self.device)
        self.state, losses = self.trainer.chunk_step(self.state, self.corpus_labels,
                                                     self.corpus_adj, block, self.gen)
        return losses

    def unit(self, k: int) -> float:
        rows = self._rows(self.steps)
        losses = self._chunk(rows).cpu()  # the chunk's one read back
        if self.chunk is None:
            self.chunk = (rows, losses)
        graphs = self.steps * self.batch
        self.counts["graphs"] = self.counts.get("graphs", 0) + graphs
        return float(graphs)

    def instrument(self, spans, kernels) -> list:
        return [(self, "unit", lambda fn: spans.wrap("train_chunk", fn))]

    def release(self) -> None:
        self.trainer = self.state = self.corpus_labels = self.corpus_adj = None

    def reference_steps(self, prec: str, batch_fraction: float = 1.0):
        """The reference's three steps (losses, first gradient, weights
        after them), then the losses of the window's first chunk's first
        three steps from the program's state after the three."""
        m = common.model_settings(self.cfg)

        def batches(rows):
            return [(torch.as_tensor(self.labels[r], device=self.device),
                     torch.as_tensor(self.adj[r], device=self.device)) for r in rows]

        clip = self.cfg["train"]["clip_norm"]
        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        losses, g1, p3 = ref_pace.train_steps(self.weights, batches(self.first_rows), m, self.lr,
                                              clip, gen, prec, batch_fraction)
        p3_program = {k: v.to(self.device) for k, v in self.p3.items()}
        chunk, _, _ = ref_pace.train_steps(p3_program, batches(self.chunk[0][:CHECKED_STEPS]), m,
                                           self.lr, clip, gen, prec, batch_fraction,
                                           moments=self.moments3)
        return losses, g1, p3, chunk

    def control(self) -> dict:
        """The reference in the program's place with TF32 products, and with
        half of each batch left out (the loss scaled to the whole batch)."""
        return {"control": self.check("tf32"), "half_batch": self.check("fp32", 0.5)}

    def check(self, prec: str, batch_fraction: float = 1.0) -> list:
        """The program's numbers against the float32 reference; with
        ``prec`` other than 'fp32' (or a ``batch_fraction``), those of the
        reference at that precision (on that share of each batch) in the
        program's place."""
        ref_pace.exact_matmul()
        losses, g1, p3, chunk = self.reference_steps("fp32")
        if prec == "fp32" and batch_fraction == 1.0:
            got_losses, got_g1, got_p3 = self.losses, self.g1, self.p3
            got_chunk = self.chunk[1][:CHECKED_STEPS]
        else:
            got_losses, got_g1, got_p3, got_chunk = self.reference_steps(prec, batch_fraction)
        ref_g = {k: float(v.double().norm()) for k, v in g1.items()}
        grad_gap = worst_leaf({k: float(v.double().norm()) for k, v in got_g1.items()}, ref_g)
        moved = {k for k, v in ref_g.items() if v >= 1e-3 * float(np.median(list(ref_g.values())))}
        step_gap = worst_leaf(
            {k: float((got_p3[k].cpu() - self.p0[k]).double().norm()) for k in moved},
            {k: float((p3[k].cpu() - self.p0[k]).double().norm()) for k in moved})
        return [
            {"name": "loss_rel_err", "value": loss_gap(got_losses, losses)},
            {"name": "grad_norm_gap", "value": grad_gap},
            {"name": "update_norm_gap", "value": step_gap},
            {"name": "chunk_loss_rel_err", "value": loss_gap(got_chunk, chunk)},
        ]


def loss_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative gap of the steps' total losses."""
    got, want = got.cpu().double()[:, 0], want.cpu().double()[:, 0]
    return float(((got - want).abs() / want.abs()).max())


def worst_leaf(got: dict, want: dict) -> float:
    """max over leaves of |norm_got - norm_want| / max(norm_want, the median
    leaf's norm)."""
    median = float(np.median(list(want.values())))
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in want)
