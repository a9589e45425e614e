"""VAE training loop (torch).

Counterpart of ``dags_vae_search_tpu/training/train.py``.  A train step is
the loss summed over the batch, ``backward()``, a global-norm clip done the
way optax does it (scale by ``clip_norm / norm`` when the norm reaches the
limit; no epsilon), and ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8,
bias-corrected as optax's Adam).  Per epoch the learning rate follows a
host-side ``ReduceLROnPlateau`` state machine or a linear-warmup cosine
schedule, and an optional ``checkpoint_fn`` runs.

Two loops cover an epoch with the same batches in the same order (one numpy
permutation per epoch, drawn as the JAX package draws it):

- per step (``steps_per_call == 1``): each batch is gathered on the host
  and copied to the device;
- chunked (``steps_per_call > 1``): the corpus moves to the device once,
  each block of K step indices is copied once, and K steps run with no host
  synchronisation; their ``[K, 3]`` losses are stacked on the device and
  read once per chunk.  The tail of the epoch runs as one shorter chunk.

Dropout and the reparameterization noise draw from one ``torch.Generator``
on the model's device, seeded from ``TrainConfig.seed`` and advanced step
by step, so both loops train the same parameters from the same seed.

Data parallel (``mesh``, a ``parallel.mesh.Mesh``): each rank holds the
parameters (broadcast from rank 0 by ``init_state``) and the whole corpus,
draws the same epoch permutation, takes its contiguous slice of every batch
and computes its loss and gradients; one ``all_reduce(SUM)`` per step of
the flattened gradients and the three losses then gives every rank the
global batch's sums, before the clip, as the one-process step has them
(the loss is a batch sum, and ``DistributedDataParallel``'s average would
shrink the gradients by the world size and move the clip).  The noise of
the global batch is drawn on every rank from the shared seed and sliced,
so with dropout 0 a mesh run computes the one-process run (up to the order
of float32 sums).  Dropout masks come from a generator of each rank's own
(seed, rank), so with dropout > 0 a mesh run equals the one-process run in
distribution only.  A world of one is bit-identical to ``mesh=None``.
Checkpoints are written by rank 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE
from dags_vae_search_tpu_torch.parallel import mesh as mesh_lib
from dags_vae_search_tpu_torch.training import data as data_lib
from dags_vae_search_tpu_torch.utils import profiling
from dags_vae_search_tpu_torch.utils.debug import nan_guard


@dataclass
class TrainConfig:
    batch_size: int = 32
    epochs: int = 10
    learning_rate: float = 1e-4
    clip_norm: float = 1.0
    # ReduceLROnPlateau defaults (mode 'min', relative threshold)
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    plateau_threshold: float = 1e-4
    min_learning_rate: float = 0.0
    # 'plateau', or 'cosine' (linear warmup_epochs, then cosine decay to
    # min_learning_rate); both set the optimizer's lr from the host per epoch
    lr_schedule: str = "plateau"
    warmup_epochs: int = 5
    seed: int = 42
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    log_every: int = 100
    # > 1: the chunked loop, K optimizer steps per host round trip with the
    # corpus on the device; 1: the per-step loop
    steps_per_call: int = 1


def _dense_adj(adj: torch.Tensor, n: int) -> torch.Tensor:
    """Dense float32 adjacency from either encoding.

    uint8 input holds ``np.packbits`` rows (MSB first): unpack with shifts
    and trim the byte padding to ``n``; anything else is already dense and
    only needs a cast.
    """
    if adj.dtype != torch.uint8:
        return adj.to(torch.float32)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=adj.device)
    bits = (adj[..., None] >> shifts) & 1
    return bits.reshape(*adj.shape[:-1], -1)[..., :n].to(torch.float32)


class PlateauState(NamedTuple):
    """Host-side ReduceLROnPlateau (mode='min', rel threshold)."""

    best: float
    bad_epochs: int
    lr: float

    def step(self, value: float, config: TrainConfig) -> "PlateauState":
        if value < self.best * (1.0 - config.plateau_threshold):
            return PlateauState(value, 0, self.lr)
        bad = self.bad_epochs + 1
        if bad > config.plateau_patience:
            new_lr = max(self.lr * config.plateau_factor, config.min_learning_rate)
            return PlateauState(self.best, 0, new_lr)
        return PlateauState(self.best, bad, self.lr)


def cosine_lr(epoch: int, total_epochs: int, config: TrainConfig) -> float:
    """Linear warmup then cosine decay, computed per epoch (1-indexed)."""
    peak = config.learning_rate
    floor = config.min_learning_rate
    warm = max(config.warmup_epochs, 0)
    if warm and epoch <= warm:
        return peak * epoch / warm
    span = max(total_epochs - warm, 1)
    t = min(max(epoch - warm, 0) / span, 1.0)
    return floor + 0.5 * (peak - floor) * (1.0 + float(np.cos(np.pi * t)))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: when the global norm is at
    least ``max_norm``, every gradient becomes ``g / norm * max_norm``;
    below it they are left as they are.  Stays on the device (no host read)
    and returns the norm.  ``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (norm + 1e-6)`` instead, so it is not used."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0).to(norm.dtype))
    return norm


class TrainState(NamedTuple):
    model: PaceVAE
    optimizer: torch.optim.Optimizer
    step: int


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class Trainer:
    """Trains ``model`` (a ``PaceVAE`` on its device) under ``config``; with
    ``mesh``, data parallel over its ranks (the model on ``mesh.device``)."""

    def __init__(self, model: PaceVAE, config: TrainConfig,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.model = model
        self.config = config
        self.mesh = mesh
        # each rank's own dropout stream; the noise comes from fit's generator
        self._mask_generator = None
        if mesh is not None and mesh.world_size > 1:
            self._mask_generator = torch.Generator(device=mesh.device)
            self._seed_masks()

    def _seed_masks(self) -> None:
        if self._mask_generator is not None:
            self._mask_generator.manual_seed(mesh_lib.rank_seed(self.config.seed, self.mesh.rank))

    def make_optimizer(self, model: torch.nn.Module) -> torch.optim.Adam:
        """Adam with optax's defaults (betas 0.9/0.999, eps 1e-8) at the
        config's learning rate."""
        return torch.optim.Adam(
            model.parameters(), lr=self.config.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )

    def init_state(self, seed: int = 0) -> TrainState:
        """Weights drawn from ``seed`` as ``make_model`` draws them (on the
        CPU, then moved back to the model's device), fresh Adam moments."""
        dev = _device(self.model)
        self.model.to("cpu")
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(dev)
        if self.mesh is not None:
            mesh_lib.replicate_tree(self.mesh, list(self.model.parameters()))
        return TrainState(self.model, self.make_optimizer(self.model), 0)

    def set_learning_rate(self, state: TrainState, lr: float) -> TrainState:
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        return state

    # ------------------------------------------------------------- the step

    def compute_gradients(
        self, state: TrainState, labels: torch.Tensor, adj: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Loss over the batch and its gradients in ``param.grad`` (train
        mode: dropout and the reparameterization noise on, drawn from
        ``generator``).  Returns the device tensor ``[total, recon, kld]``,
        each summed over the batch.  With a mesh, ``labels`` and ``adj`` are
        this rank's slice of the global batch, ``generator`` is in the same
        state on every rank, and the gradients and losses returned are the
        global batch's sums."""
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        mesh = self.mesh
        if mesh is not None and mesh.world_size > 1:
            total, recon, kld = model.loss(labels, adj, generator=self._mask_generator,
                                           noise_generator=generator,
                                           noise_shard=(mesh.rank, mesh.world_size))
        else:
            total, recon, kld = model.loss(labels, adj, generator=generator)
        total.backward()
        losses = torch.stack([total, recon, kld]).detach()
        if mesh is not None:
            losses = self._sum_over_ranks(model, losses)
        return losses

    def _sum_over_ranks(self, model: torch.nn.Module, losses: torch.Tensor) -> torch.Tensor:
        """One ``all_reduce(SUM)`` of the flattened gradients and the
        losses; the gradients are written back in place."""
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [losses])
        torch.distributed.all_reduce(flat, op=torch.distributed.ReduceOp.SUM,
                                     group=self.mesh.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:]

    def apply_gradients(self, state: TrainState) -> TrainState:
        """Global-norm clip then one Adam update from ``param.grad``."""
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        clip_by_global_norm(grads, self.config.clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1)

    def train_step(
        self, state: TrainState, labels: torch.Tensor, adj: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on a device batch; returns the new state and
        the batch's ``[total, recon, kld]`` losses (a device tensor)."""
        losses = self.compute_gradients(state, labels, adj, generator)
        return self.apply_gradients(state), losses

    def chunk_step(
        self, state: TrainState, corpus_labels: torch.Tensor, corpus_adj: torch.Tensor,
        block: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, torch.Tensor]:
        """``block.shape[0]`` steps on batches gathered on the device from
        the resident corpus (dense float32 or packed uint8 adjacency);
        nothing is read back.  Returns the state and the ``[K, 3]`` losses.
        With a mesh, ``block`` holds the global batches' indices and each
        rank gathers its slice of them."""
        n = corpus_labels.shape[-1]
        if self.mesh is not None:
            block = block[:, self.mesh.local(block.shape[1])]
        losses = []
        for step_idx in block:
            labels = corpus_labels.index_select(0, step_idx).to(torch.int32)
            adj = _dense_adj(corpus_adj.index_select(0, step_idx), n)
            state, loss = self.train_step(state, labels, adj, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    # ------------------------------------------------------------ the loops

    def corpus_to_device(self, corpus: data_lib.Corpus, dev, log) -> tuple:
        """The corpus on the device, sent as packed bits with int16 labels.
        A dense corpus unpacks there once; a packed one stays packed and
        each gathered batch unpacks."""
        t_put = time.time()
        host_labels = corpus.labels.astype(np.int16)
        if corpus.packed_bits is not None:
            host_packed = corpus.packed_bits
        else:
            host_packed = np.packbits((np.asarray(corpus.adj) > 0).astype(np.uint8), axis=-1)
        labels = torch.as_tensor(host_labels, device=dev)
        adj = torch.as_tensor(host_packed, device=dev)
        if corpus.packed_bits is None:
            adj = _dense_adj(adj, corpus.num_vertices)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sent_mb = (host_packed.nbytes + host_labels.nbytes) / 1e6
        log(f"corpus -> device: {sent_mb:,.1f} MB sent in {time.time() - t_put:.2f}s")
        return labels, adj

    def fit(
        self,
        state: TrainState,
        corpus: data_lib.Corpus,
        epochs: Optional[int] = None,
        start_epoch: int = 1,
        log: Callable[[str], None] = print,
        checkpoint_fn: Optional[Callable[[int, TrainState], None]] = None,
    ) -> tuple:
        """Epoch loop; returns (state, history of per-epoch dicts)."""
        config = self.config
        epochs = epochs if epochs is not None else config.epochs
        dev = _device(state.model)
        rng_np = np.random.default_rng(config.seed)
        generator = torch.Generator(device=dev).manual_seed(config.seed)
        self._seed_masks()
        plateau = PlateauState(float("inf"), 0, config.learning_rate)
        history: List[Dict] = []
        time_start = time.time()
        device_loop = config.steps_per_call > 1
        b = config.batch_size
        if device_loop:
            corpus_labels, corpus_adj = self.corpus_to_device(corpus, dev, log)

        horizon = start_epoch + epochs - 1
        for epoch in range(start_epoch, start_epoch + epochs):
            if config.lr_schedule == "cosine":
                lr_now = cosine_lr(epoch, horizon, config)
                if lr_now != plateau.lr:
                    state = self.set_learning_rate(state, lr_now)
                    plateau = plateau._replace(lr=lr_now)
            last = None
            batches = 0
            dispatches = 0
            epoch_t0 = time.time()
            timer = profiling.StepTimer(window=10_000)
            if device_loop:
                steps = len(corpus) // b
                if steps == 0:
                    raise ValueError("corpus smaller than one batch")
                perm = rng_np.permutation(len(corpus))[: steps * b].reshape(steps, b)
                k = min(config.steps_per_call, steps)
                # the tail (steps % k) runs as one shorter chunk
                for start in range(0, steps, k):
                    kc = min(k, steps - start)
                    t_chunk = time.time()
                    with timer.step(items=kc), profiling.span("train_chunk"):
                        block = torch.as_tensor(perm[start:start + kc], device=dev)
                        state, stacked = self.chunk_step(
                            state, corpus_labels, corpus_adj, block, generator
                        )
                        stacked = stacked.cpu().numpy()  # the chunk's one read back
                    if epoch == start_epoch and batches == 0:
                        log(f"first chunk: {time.time() - t_chunk:.2f}s")
                    batches += kc
                    dispatches += 1
                    # log when a multiple of log_every was crossed this chunk
                    if config.log_every and (
                        batches // config.log_every != (batches - kc) // config.log_every
                    ):
                        vals = stacked[-1]
                        log(
                            f"epoch {epoch} batch {batches}: loss {vals[0] / b:.5f} "
                            f"recon {vals[1] / b:.5f} kld {vals[2] / b:.5f}"
                        )
                last = torch.as_tensor(stacked[-1])
            else:
                for labels, adj in data_lib.epoch_batches(corpus, b, rng_np):
                    # no per-step read back: the timer measures what the host
                    # waits for per step, the epoch clock the true step time
                    with timer.step(items=1), profiling.span("train_step"):
                        if self.mesh is not None:
                            labels, adj = mesh_lib.shard_batch(self.mesh, labels, adj)
                        else:
                            labels = torch.as_tensor(labels, device=dev)
                            adj = torch.as_tensor(adj, device=dev)
                        state, last = self.train_step(state, labels, adj, generator)
                    batches += 1
                    if config.log_every and batches % config.log_every == 0:
                        vals = last.tolist()
                        log(
                            f"epoch {epoch} batch {batches}: loss {vals[0] / b:.5f} "
                            f"recon {vals[1] / b:.5f} kld {vals[2] / b:.5f}"
                        )

            if last is None:
                last = torch.full((3,), float("nan"))
            loss_value, recon_value, kld_value = last.tolist()
            if not np.isfinite(loss_value):
                nan_guard(dict(zip(("loss", "recon", "kld"), last)), name=f"epoch {epoch} metrics")
            if config.lr_schedule == "plateau":
                new_plateau = plateau.step(loss_value, config)
                if new_plateau.lr != plateau.lr:
                    log(f"epoch {epoch}: reducing lr to {new_plateau.lr:.2e}")
                    state = self.set_learning_rate(state, new_plateau.lr)
                plateau = new_plateau

            epoch_dt = time.time() - epoch_t0
            entry = {
                "epoch": epoch,
                "loss_per_graph": loss_value / b,
                "recon_per_graph": recon_value / b,
                "kld_per_graph": kld_value / b,
                "epoch_seconds": epoch_dt,
                "graphs_per_second": batches * b / epoch_dt,
                # per optimizer step, to the epoch's final read back
                "step_ms": 1e3 * epoch_dt / max(batches, 1),
                # host time per step: a whole chunk's (synchronised) time over
                # its mean length on the chunked loop, the enqueue and batch
                # copy on the per-step loop
                "dispatch_ms": 1e3 * timer.mean_step_seconds()
                / max(batches / dispatches if device_loop and dispatches else 1.0, 1e-9),
                "lr": plateau.lr,
            }
            history.append(entry)
            log(
                f"====> epoch {epoch} loss {entry['loss_per_graph']:.5f} "
                f"({entry['graphs_per_second']:,.0f} graphs/s, "
                f"total {time.time() - time_start:.1f}s)"
            )
            if checkpoint_fn is not None and epoch % config.checkpoint_every == 0 \
                    and (self.mesh is None or self.mesh.rank == 0):
                checkpoint_fn(epoch, state)

        return state, history

    def fit_resilient(
        self,
        state: TrainState,
        corpus: data_lib.Corpus,
        checkpoint_dir: str,
        max_restarts: int = 3,
        epochs: Optional[int] = None,
        start_epoch: int = 1,
        log: Callable[[str], None] = print,
    ) -> tuple:
        """Crash-resilient fit: a checkpoint per epoch; on failure, restore
        the last epoch's params and continue with fresh Adam moments.  Gives
        up (re-raises) after ``max_restarts`` restarts."""
        from dags_vae_search_tpu_torch.training import checkpoint as ckpt

        total = epochs if epochs is not None else self.config.epochs
        history: List[Dict] = []
        restarts = 0

        def save(epoch, st):
            ckpt.save_checkpoint(checkpoint_dir, epoch, {"params": st.model.state_dict()})

        while len(history) < total:
            begin = start_epoch + len(history)
            try:
                state, part = self.fit(
                    state, corpus, epochs=total - len(history), start_epoch=begin, log=log,
                    checkpoint_fn=save,
                )
                history.extend(part)
            except Exception as exc:  # noqa: BLE001 — elastic boundary, re-raised past the budget
                restarts += 1
                if restarts > max_restarts:
                    raise
                latest = ckpt.latest_epoch(checkpoint_dir)
                log(
                    f"fit_resilient: restart {restarts}/{max_restarts} after "
                    f"{type(exc).__name__}: {exc}; resuming from epoch {latest}"
                )
                if latest is not None and latest >= begin:
                    params = ckpt.restore_params(checkpoint_dir, latest, state.model.state_dict())
                    state.model.load_state_dict(params)
                    state = state._replace(optimizer=self.make_optimizer(state.model))
                    history.extend(
                        {"epoch": e, "recovered": True} for e in range(begin, latest + 1)
                    )
        return state, history
