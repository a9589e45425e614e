"""PACE transformer DAG-VAE (torch).

Counterpart of ``dags_vae_search_tpu/models/pace_vae.py``, with the same math
and parameter names:

  label embed Linear(L, E) + ReLU, concatenated with the GNN positional
  encoding (E) -> d_model = 2E; post-LN transformer encoder (mask =
  ancestors + self) -> flatten -> fc1/fc2 = mu/logvar; fc3(z) -> decoder
  memory [N, d]; teacher-forced post-LN decoder -> add_node / add_edge
  heads; loss = node NLL + edge BCE (sums) + beta * KL.

Slot-indexed DAGs have the identity as topological order, so the position
one-hot is a constant eye and the positional input is ``[I ‖ A^T]``.
Dropout and the reparameterization noise are active in ``train()`` mode
only, and draw from the ``generator`` the caller passes (the device's
default generator when None).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dags_vae_search_tpu_torch.graphs.dag import NUM_VIRTUAL, attention_allowed, pace_wrap
from dags_vae_search_tpu_torch.models.transformer import (
    Decoder,
    Dense,
    Encoder,
    dropout,
    round_operand,
)


class PaceVAE(nn.Module):
    """The DAG-VAE over ``num_real_vertices``-node labeled DAGs; virtual
    vertices and labels (+3) are handled internally.  The asia flagship
    (8, 8, embed=32, heads=8, layers=3, latent=32, fc_hidden=32) has 284,556
    parameters."""

    def __init__(
        self,
        num_real_vertices: int,
        real_label_cardinality: int,
        embed_size: int = 32,
        num_heads: int = 8,
        num_layers: int = 3,
        latent_size: int = 32,
        fc_hidden: int = 32,
        dropout: float = 0.15,
        beta: float = 0.005,
        epsilon_scale: float = 0.01,
        loss_variant: str = "v3",
        edge_readout: bool = False,
        edge_readout_rank: int = 0,
        matmul_dtype: Optional[str] = None,
    ):
        super().__init__()
        self.num_real_vertices = num_real_vertices
        self.real_label_cardinality = real_label_cardinality
        self.embed_size = embed_size
        self.latent_size = latent_size
        self.dropout = dropout
        self.beta = beta
        self.epsilon_scale = epsilon_scale
        # 'v3' = BCE with logits; 'v1' = BCE on sigmoid probabilities with
        # the log clamped at -100
        self.loss_variant = loss_variant
        self.edge_readout = edge_readout
        self.edge_readout_rank = edge_readout_rank
        self.matmul_dtype = matmul_dtype

        n, d, md = self.max_n, self.d_model, matmul_dtype
        self.pos_w1 = nn.Parameter(torch.empty(2 * n, 2 * embed_size))
        self.pos_w2 = nn.Parameter(torch.empty(2 * embed_size, embed_size))
        self.label_embed = Dense(self.cardinality, embed_size, md)
        self.encoder = Encoder(d, num_layers, num_heads, dropout, md)
        self.fc1 = Dense(n * d, latent_size, md)
        self.fc2 = Dense(n * d, latent_size, md)
        self.fc3 = Dense(latent_size, n * d, md)
        self.decoder = Decoder(d, num_layers, num_heads, dropout, md)
        self.add_node_hidden = Dense(d, fc_hidden, md)
        self.add_node_out = Dense(fc_hidden, self.cardinality, md)
        self.add_edge_hidden = Dense(2 * d, d, md)
        self.add_edge_out = Dense(d, 1, md)
        if edge_readout:
            if edge_readout_rank > 0:
                r = edge_readout_rank
                self.edge_readout_u = Dense(latent_size, (n - 1) * r, md)
                self.edge_readout_v = Dense(latent_size, (n - 1) * r, md)
            else:
                self.edge_readout_fc = Dense(latent_size, (n - 1) * (n - 1), md)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter: positional weights xavier-uniform with
        gain sqrt(2), Dense layers torch's default, LayerNorms ones/zeros."""
        with torch.no_grad():
            for w in (self.pos_w1, self.pos_w2):
                bound = math.sqrt(2.0) * math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                w.uniform_(-bound, bound, generator=generator)
            for module in self.modules():
                if isinstance(module, Dense):
                    module.reset_parameters(generator)
                elif isinstance(module, nn.LayerNorm):
                    module.reset_parameters()

    @property
    def max_n(self) -> int:
        return self.num_real_vertices + NUM_VIRTUAL

    @property
    def cardinality(self) -> int:
        return self.real_label_cardinality + NUM_VIRTUAL

    @property
    def d_model(self) -> int:
        return 2 * self.embed_size

    # ---------------------------------------------------------------- utils

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(x, self.dropout, self.training, generator)

    def _pos_encoding(self, adj: torch.Tensor, generator=None) -> torch.Tensor:
        """[I ‖ A^T] -> relu(. W1) -> dropout -> . W2 -> dropout; [B, N, E]."""
        b, n, _ = adj.shape
        eye = torch.eye(n, dtype=adj.dtype, device=adj.device).expand(b, n, n)
        x = torch.cat([eye, adj.transpose(-1, -2)], dim=-1)
        md = self.matmul_dtype
        h = self._drop(F.relu(round_operand(x, md) @ round_operand(self.pos_w1, md)), generator)
        return self._drop(round_operand(h, md) @ round_operand(self.pos_w2, md), generator)

    def _vertex_features(self, labels: torch.Tensor, adj: torch.Tensor,
                         generator=None) -> torch.Tensor:
        """concat(label embedding, positional embedding) -> [B, N, d_model]."""
        card = torch.arange(self.cardinality, device=labels.device)
        labels_1h = (labels[..., None] == card).to(torch.float32)
        emb = F.relu(self.label_embed(labels_1h))
        return torch.cat([emb, self._pos_encoding(adj, generator)], dim=-1)

    def _add_node(self, h: torch.Tensor) -> torch.Tensor:
        return self.add_node_out(F.relu(self.add_node_hidden(h)))

    def _add_edge(self, h: torch.Tensor) -> torch.Tensor:
        return self.add_edge_out(F.relu(self.add_edge_hidden(h)))

    def _edge_bias(self, z: torch.Tensor, n: int) -> torch.Tensor:
        """z -> per-pair edge-logit bias [B, n-1, n-1] (row i = child slot,
        column j = parent slot, loss-pair indexing).  The factors' product
        is float32 whatever ``matmul_dtype``: the JAX package does not round
        its operands."""
        if self.edge_readout_rank > 0:
            r = self.edge_readout_rank
            u = self.edge_readout_u(z).reshape(-1, n - 1, r)
            v = self.edge_readout_v(z).reshape(-1, n - 1, r)
            return (u @ v.transpose(1, 2)) / (r**0.5)
        return self.edge_readout_fc(z).reshape(-1, n - 1, n - 1)

    def _edge_bias_row(self, z: torch.Tensor, n: int, i: int) -> torch.Tensor:
        """Row ``i`` of :meth:`_edge_bias`, [B, n-1]."""
        if self.edge_readout_rank > 0:
            r = self.edge_readout_rank
            u_row = self.edge_readout_u(z).reshape(-1, n - 1, r)[:, i]
            v = self.edge_readout_v(z).reshape(-1, n - 1, r)
            return (v @ u_row[..., None])[..., 0] / (r**0.5)
        return self.edge_readout_fc(z).reshape(-1, n - 1, n - 1)[:, i]

    # ------------------------------------------------------------- encoding

    def encode_wrapped(
        self, labels: torch.Tensor, adj: torch.Tensor, allowed: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar) from PACE-wrapped tensors."""
        if allowed is None:
            allowed = attention_allowed(adj)
        memory = self.encoder(self._vertex_features(labels, adj, generator), allowed, generator)
        flat = memory.reshape(memory.shape[0], self.max_n * self.d_model)
        return self.fc1(flat), self.fc2(flat)

    def encode(self, labels: torch.Tensor, adj: torch.Tensor):
        """(mu, logvar) from labeled (real-vertex) tensors."""
        wrapped = pace_wrap(labels, adj)
        return self.encode_wrapped(wrapped.labels, wrapped.adj)

    def reparameterize(
        self, mu: torch.Tensor, logvar: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        shard: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        """``mu`` in eval mode; ``mu + eps_scale * N(0, 1) * std`` in train mode.

        ``shard = (rank, world)``: the noise of a batch ``world`` times as
        large is drawn and this rank's rows are kept, so ranks whose
        generators are in one state split the draw one process makes."""
        if not self.training:
            return mu
        std = torch.exp(0.5 * logvar)
        if shard is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        else:
            rank, world = shard
            b = mu.shape[0]
            eps = torch.randn((world * b, *mu.shape[1:]), generator=generator,
                              device=mu.device)[rank * b:(rank + 1) * b]
        return mu + eps * self.epsilon_scale * std

    # ------------------------------------------------------------- decoding

    def decoder_output(
        self, z: torch.Tensor, labels: torch.Tensor, adj: torch.Tensor, allowed: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Teacher-forced decoder hidden states [B, N, d] for PACE tensors."""
        memory = self.fc3(z).reshape(z.shape[0], self.max_n, self.d_model)
        return self.decoder(
            self._vertex_features(labels, adj, generator), memory, allowed, generator
        )

    def decode_step(
        self,
        z: torch.Tensor,
        labels: torch.Tensor,  # int32[B, N] current PACE labels (pad=OUTPUT)
        adj: torch.Tensor,  # float32[B, N, N] current PACE adjacency
        allowed: torch.Tensor,  # bool[B, N, N] attention mask for this step
        idx: int,  # slot being generated (2..N-1)
    ):
        """One sampling-decode step: (type logits [B, L], parent-edge probs
        [B, N] indexed by parent slot)."""
        out = self.decoder_output(z, labels, adj, allowed)
        h_new = out[:, idx - 1]
        type_logits = self._add_node(h_new)  # [B, L]

        # Parent slot p pairs h_new with hidden out[p-1].
        parent_hidden = torch.roll(out, 1, dims=1)
        pair = torch.cat([h_new[:, None, :].expand_as(parent_hidden), parent_hidden], dim=-1)
        edge_logits = self._add_edge(pair)[..., 0]  # [B, N]
        if self.edge_readout:
            n = labels.shape[-1]
            # loss pair (i, j) = (slot idx - 1, parent slot p - 1): row
            # i = idx-1, shifted one slot right so position p reads [i, p-1]
            row = F.pad(self._edge_bias_row(z, n, idx - 1), (0, 1))
            edge_logits = edge_logits + torch.roll(row, 1, dims=-1)
        return type_logits, torch.sigmoid(edge_logits)

    @torch.no_grad()
    def decode_memory(self, z: torch.Tensor) -> "DecodeCache":
        """What a sampling decode of ``z`` computes once (:class:`DecodeCache`):
        each decoder layer's memory keys and values and its buffers, the edge
        readout, and the weights a position's step reads, rounded."""
        b, n, d = z.shape[0], self.max_n, self.d_model
        md = self.matmul_dtype
        memory = self.fc3(z).reshape(b, n, d)
        w_edge = round_operand(self.add_edge_hidden.weight, md)
        readout = None
        if self.edge_readout:
            if self.edge_readout_rank > 0:
                r = self.edge_readout_rank
                u = self.edge_readout_u(z).reshape(b, n - 1, r)
                # v by parent slot: slot p reads row p - 1, slot 0 a zero row
                v = F.pad(self.edge_readout_v(z).reshape(b, n - 1, r), (0, 0, 1, 0))
                readout = (u, v)
            else:
                # row i = child slot i + 1; column p = parent slot p (p - 1
                # of the loss pair), column 0 zero
                readout = F.pad(self.edge_readout_fc(z).reshape(b, n - 1, n - 1), (1, 0))
        # the label embedding of a one-hot row is a row of this table
        table = F.relu(round_operand(self.label_embed.weight, md).t() + self.label_embed.bias)
        return DecodeCache(
            layers=[getattr(self.decoder, f"layer{i}").begin_decode(memory)
                    for i in range(self.decoder.num_layers)],
            label_table=table, pos_w1=round_operand(self.pos_w1, md),
            pos_w2=round_operand(self.pos_w2, md),
            edge_w_new=w_edge[:, :d], edge_w_parent_t=w_edge[:, d:].t(),
            parent_half=torch.zeros((n, b, d), device=z.device), readout=readout)

    @torch.no_grad()
    def decode_step_cached(
        self,
        cache: "DecodeCache",
        labels: torch.Tensor,  # int32[B, N] current PACE labels (pad=OUTPUT)
        adj: torch.Tensor,  # float32[B, N, N] current PACE adjacency
        reach: torch.Tensor,  # float32[B, N, N] paths among built slots
        idx: int,  # slot being generated (2..N-1)
    ):
        """:meth:`decode_step` in eval mode, from ``cache``: only the positions
        built since the cache's last step (0 and 1 at slot 2, then ``idx -
        1``) go through the decoder, one at a time, since a built position
        attends only its ancestors and itself and so never changes.  Returns
        what :meth:`decode_step` returns; the edge probabilities at parent
        slots ``idx ..`` are placeholders (0.5)."""
        n, md = labels.shape[-1], self.matmul_dtype
        if not cache.length < idx <= n - 1:
            raise ValueError(f"slot {idx} after a cache of {cache.length} positions")
        for j in range(cache.length, idx):
            h = self._decode_position(cache, labels, adj, reach, j)
        cache.length = idx

        type_logits = self._add_node(h)
        # parent slot p pairs h with position p - 1: [h ‖ h_p] W^T + b
        new_half = F.linear(round_operand(h, md), cache.edge_w_new, self.add_edge_hidden.bias)
        hidden = F.relu(new_half + cache.parent_half[:idx])  # [idx, B, d]
        edge_logits = self.add_edge_out(hidden)[..., 0].t()  # [B, idx], by parent slot
        if self.edge_readout:
            if self.edge_readout_rank > 0:
                u, v = cache.readout
                row = (v[:, :idx] @ u[:, idx - 1, :, None])[..., 0] / (self.edge_readout_rank**0.5)
            else:
                row = cache.readout[:, idx - 1, :idx]
            edge_logits = edge_logits + row
        return type_logits, F.pad(torch.sigmoid(edge_logits), (0, n - idx), value=0.5)

    def _decode_position(self, cache, labels, adj, reach, j: int) -> torch.Tensor:
        """Position ``j`` through the decoder (its keys and values and its half
        of the first edge layer kept in ``cache``): its output [B, d]."""
        md, n = self.matmul_dtype, self.max_n
        # vertex features: the label's embedding, and the positional row
        # [e_j ‖ A^T_j] through the positional MLP
        pos = F.relu(torch.addmm(cache.pos_w1[j], adj[:, :, j], cache.pos_w1[n:]))
        tgt = torch.cat([cache.label_table[labels[:, j]],
                         round_operand(pos, md) @ cache.pos_w2], dim=-1)
        # j may attend k <= j iff path k -> j or k == j
        mask = reach[:, :j + 1, j]
        for i, state in enumerate(cache.layers):
            tgt = getattr(self.decoder, f"layer{i}").step(tgt, state, j, mask)
        torch.mm(round_operand(tgt, md), cache.edge_w_parent_t, out=cache.parent_half[j + 1])
        return tgt

    # ----------------------------------------------------------------- loss

    def loss_wrapped(
        self,
        labels: torch.Tensor,
        adj: torch.Tensor,
        allowed: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        noise_generator: Optional[torch.Generator] = None,
        noise_shard: Optional[Tuple[int, int]] = None,
    ):
        """(total, recon_nll, kld) on PACE-wrapped tensors, summed over the
        batch.  Dropout draws from ``generator``, the reparameterization
        noise from ``noise_generator`` (``generator`` when None) as
        :meth:`reparameterize` with ``shard=noise_shard`` draws it."""
        if allowed is None:
            allowed = attention_allowed(adj)
        n = labels.shape[1]
        mu, logvar = self.encode_wrapped(labels, adj, allowed, generator)
        z = self.reparameterize(mu, logvar, generator if noise_generator is None else noise_generator,
                                noise_shard)
        out = self.decoder_output(z, labels, adj, allowed, generator)

        # Node NLL: position t predicts the label of vertex t+1, t < n-1.
        node_logp = torch.log_softmax(self._add_node(out), dim=-1)
        card = torch.arange(self.cardinality, device=labels.device)
        targets = (labels[:, 1:, None] == card).to(torch.float32)
        node_ll = (node_logp[:, : n - 1, :] * targets).sum()

        # Edge BCE over static pairs (i > j, both < n-1): logit from
        # [out_i ‖ out_j], target adj[j+1, i+1].  The pair list is made on
        # the device (np.tril_indices order): a host copy would wait for it.
        pi, pj = torch.tril_indices(n - 1, n - 1, offset=-1, device=labels.device)
        logits = self._add_edge(torch.cat([out[:, pi, :], out[:, pj, :]], dim=-1))[..., 0]
        if self.edge_readout:
            logits = logits + self._edge_bias(z, n)[:, pi, pj]
        edge_targets = adj[:, pj + 1, pi + 1]
        if self.loss_variant == "v1":
            probs = torch.sigmoid(logits)
            log_p = torch.clamp(torch.log(probs), min=-100.0)
            log_1p = torch.clamp(torch.log(1.0 - probs), min=-100.0)
            edge_ll = (edge_targets * log_p + (1.0 - edge_targets) * log_1p).sum()
        else:
            edge_ll = (
                edge_targets * F.logsigmoid(logits)
                + (1.0 - edge_targets) * F.logsigmoid(-logits)
            ).sum()

        log_likelihood = node_ll + edge_ll
        kld = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar))
        return -log_likelihood + self.beta * kld, -log_likelihood, kld

    def loss(self, labels: torch.Tensor, adj: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise_generator: Optional[torch.Generator] = None,
             noise_shard: Optional[Tuple[int, int]] = None):
        """(total, recon_nll, kld) from labeled (real-vertex) tensors; the
        generators and ``noise_shard`` as :meth:`loss_wrapped` takes them."""
        wrapped = pace_wrap(labels, adj)
        return self.loss_wrapped(wrapped.labels, wrapped.adj, generator=generator,
                                 noise_generator=noise_generator, noise_shard=noise_shard)

    def forward(self, labels: torch.Tensor, adj: torch.Tensor):
        return self.loss(labels, adj)


@dataclass
class DecodeCache:
    """One sampling decode's state for :meth:`PaceVAE.decode_step_cached`,
    made by :meth:`PaceVAE.decode_memory`: ``layers`` each decoder layer's
    (``DecoderLayer.begin_decode``: its keys and values of the positions
    decoded so far, the memory's); ``parent_half`` [N, B, d] each decoded
    position's half of ``add_edge_hidden`` (no bias) by the parent slot it
    becomes (position j at slot j + 1); ``readout`` the edge readout: None,
    the bias rows [B, N - 1, N] by parent slot, or the rank factors (u [B, N
    - 1, r], v by parent slot [B, N, r]); the rest weights rounded to
    ``matmul_dtype`` and constants.  ``length`` positions are decoded."""

    layers: list
    label_table: torch.Tensor
    pos_w1: torch.Tensor
    pos_w2: torch.Tensor
    edge_w_new: torch.Tensor
    edge_w_parent_t: torch.Tensor
    parent_half: torch.Tensor
    readout: object
    length: int = 0


def make_model(seed: int = 0, device="cuda", **kwargs) -> PaceVAE:
    """A ``PaceVAE(**kwargs)`` with weights drawn from ``seed``, on ``device``."""
    model = PaceVAE(**kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def make_asia_model(seed: int = 0, device="cuda") -> PaceVAE:
    """The flagship config (8 vertices, 8 labels, defaults elsewhere)."""
    return make_model(seed, device, num_real_vertices=8, real_label_cardinality=8)


def num_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
