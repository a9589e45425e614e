"""Autoregressive sampling decode (torch).

Counterpart of ``dags_vae_search_tpu/models/decode.py``; its ``lax.scan``
over node slots is a Python loop here, and where each JAX step runs every
position through the decoder, a slot here runs only the position built last
(``PaceVAE.decode_step_cached`` over a per-call cache): a built position
attends only its ancestors and itself, so its keys, values and output never
change.  Semantics, reference quirks included:

- slots 0/1 are pre-seeded with start/input and the start->input edge;
- each step samples a node type from the ``add_node`` logits and in-edges
  from per-parent Bernoulli over ``sigmoid(add_edge([h_new ‖ h_parent]))``;
- if the *sampled* type is the output label, the new node instead connects
  every current sink and the graph freezes; the branch keys on the sampled
  type even at the last slot, where the stored label is forced to output;
- graphs that freeze early keep output-labelled placeholder slots, which
  unwrap to out-of-range labels and are counted invalid.

``constrain_labels`` restricts the categorical to the support of the
training corpora: virtual labels never appear in generated slots, the output
label only at the last slot, and (when labels are permutations) no real
label repeats.  ``max_in_degree`` keeps at most that many real parents per
node, the highest-probability ones, ties broken by slot index.

``temperature`` sharpens both heads (logits / T).  T <= 1e-3 is the exact
mode decode (argmax labels, edges at p > 0.5) and draws no random numbers;
T = 1 is the reference's sampling.  torch's generators give other numbers
than ``jax.random``, so only the mode decode is bit-comparable with JAX.

A decode runs over a :class:`DecodeWorkspace`, which holds its state and
cache.  A decode is three functions over it: :meth:`~DecodeWorkspace.memory`
(the latents' cache, the state reset), and each slot's
:meth:`~DecodeWorkspace.step` (the model) and :meth:`~DecodeWorkspace.draw`.
On the CPU a call makes a workspace and calls them directly.  On a CUDA
device the workspace lives across calls, kept by the model it decodes (and
freed with it): one for each shape and setting a call bakes in
(:func:`workspace_key`), the ``MAX_WORKSPACES`` used last.  The call that
first meets a workspace calls the functions directly and then captures each
as a CUDA graph (one for the memory, two a slot), and every later call
replays them: one launch each in place of the ~162 kernels a slot launches.  The uniforms a draw reads are drawn from the caller's
generator outside the graphs, before each draw, so the numbers, their order
and the generator's end state are those of a direct call, and the graphs
give the same bits.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple
from weakref import WeakKeyDictionary

import torch

from dags_vae_search_tpu_torch.graphs.dag import (
    LABEL_INPUT,
    LABEL_OUTPUT,
    LABEL_START,
    DagBatch,
    is_valid_labeled,
    pace_unwrap,
)
from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE
from dags_vae_search_tpu_torch.utils import profiling

#: CUDA workspaces a model keeps across calls, the least recently used
#: dropped first: the search's decode and its exploit decode, and a few more
#: shapes (BO, refine, eval) before memory holds one for every shape met.
MAX_WORKSPACES = 4

#: Each model's CUDA workspaces by key, the one used last at the end; an
#: entry goes with its model.
_workspaces: "WeakKeyDictionary[PaceVAE, OrderedDict[tuple, DecodeWorkspace]]" = (
    WeakKeyDictionary())

#: The stream each device's captures run on, one for the process (as
#: ``torch.cuda.graph`` keeps one): the libraries (cuBLAS) keep a workspace
#: for every stream they meet, so a new stream a capture would leave one
#: behind each time.
_capture_streams: dict = {}


@torch.no_grad()
def sample_decode(
    model: PaceVAE,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    constrain_labels: bool = True,
    temperature: float = 1.0,
    max_in_degree: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode latents to PACE tensors on ``z``'s device.

    Returns (labels int32[B, N], adj float32[B, N, N], finished bool[B])
    over the wrapped (N = real + 3) vertex space.  Runs the model in eval
    mode and restores its mode afterwards.
    """
    was_training = model.training
    model.eval()
    try:
        return _sample_decode(model, z, generator, constrain_labels, temperature, max_in_degree)
    finally:
        model.train(was_training)


def _sample_decode(model, z, generator, constrain_labels, temperature, max_in_degree):
    def make():
        return DecodeWorkspace(model, z.shape[0], z.device, constrain_labels, temperature,
                               max_in_degree)

    if z.is_cuda:
        key = workspace_key(model, z, constrain_labels, temperature, max_in_degree)
        ws = kept_workspace(model, key, make)
    else:
        ws = make()
    ws.load(z, temperature)
    replayed = ws.graphs is not None
    profiling.count("decode.graph_rows", z.shape[0] if replayed else 0)
    if z.is_cuda and not replayed:
        profiling.count("decode.graph_captures", 1)
        return ws.capture(model, generator)
    return ws.run(model, generator)


def kept_workspace(model: PaceVAE, key: tuple, make) -> "DecodeWorkspace":
    """``model``'s workspace under ``key``, ``make()`` where it has none; the
    model keeps the ``MAX_WORKSPACES`` used last."""
    kept = _workspaces.setdefault(model, OrderedDict())
    ws = kept.pop(key, None)
    if ws is None:
        ws = make()
    kept[key] = ws
    while len(kept) > MAX_WORKSPACES:
        kept.popitem(last=False)
    return ws


def _mask_used(model: PaceVAE, constrain_labels: bool) -> bool:
    """Whether a decode masks used labels: only where corpus labels are
    permutations."""
    return (constrain_labels
            and model.real_label_cardinality == model.num_real_vertices
            and model.real_label_cardinality > 1)


def workspace_key(model: PaceVAE, z: torch.Tensor, constrain_labels: bool, temperature: float,
                  max_in_degree: Optional[int]) -> tuple:
    """What a decode's graphs bake in: the batch, the slots and the device,
    the draw's settings, whether it is the mode decode (T <= 1e-3: no
    uniforms, other operations), and the model's settings and parameters by
    address and shape (a parameter replaced by another tensor asks for a
    new capture; one changed in place is read by the next replay)."""
    attn = model.decoder.layer0.self_attn
    return (z.shape[0], model.max_n, z.device, constrain_labels,
            _mask_used(model, constrain_labels), max_in_degree, temperature <= 1e-3,
            model.matmul_dtype, attn.num_heads,
            tuple((p.data_ptr(), tuple(p.shape)) for p in model.parameters()))


class DecodeWorkspace:
    """One decode shape's state across calls: the latents ``z`` and ``inv_t``
    (1 / T, 0-d) a call loads, the state (``labels``, ``adj``, ``reach``
    the paths among built slots, ``finished``, ``used``), the uniforms of a
    slot's draw, the cache of :meth:`PaceVAE.decode_memory` and a slot's
    logits; on a CUDA device, once captured, ``graphs``: the memory's graph
    and each slot's (step graph, draw graph).
    A workspace that has captured nothing calls the functions directly, on
    any device."""

    def __init__(self, model: PaceVAE, batch: int, device, constrain_labels: bool,
                 temperature: float, max_in_degree: Optional[int]):
        n, card = model.max_n, model.cardinality
        self.n, self.constrain_labels, self.max_in_degree = n, constrain_labels, max_in_degree
        self.hard = temperature <= 1e-3
        self.mask_used = _mask_used(model, constrain_labels)
        self.z = torch.empty((batch, model.latent_size), device=device)
        self.inv_t = torch.ones((), device=device)
        self.labels = torch.empty((batch, n), dtype=torch.int32, device=device)
        self.adj = torch.empty((batch, n, n), device=device)
        self.reach = torch.empty_like(self.adj)
        self.finished = torch.empty(batch, dtype=torch.bool, device=device)
        self.used = torch.empty((batch, card), dtype=torch.bool, device=device)
        self.u_type = torch.empty((batch, card), device=device)
        self.u_edge = torch.empty((batch, n), device=device)
        self.slot = torch.arange(n, device=device)
        self.labels_range = torch.arange(card, device=device)
        self.virtual = (self.labels_range == LABEL_START) | (self.labels_range == LABEL_INPUT)
        self.is_output_label = self.labels_range == LABEL_OUTPUT
        self.cache = self.logits = self.graphs = None

    def load(self, z: torch.Tensor, temperature: float) -> None:
        """A call's latents and 1 / T (in float32, the bits a Python scalar
        multiplies a float32 tensor by)."""
        self.z.copy_(z)
        self.inv_t.fill_(1.0 / max(temperature, 1e-3))

    def memory(self, model: PaceVAE) -> None:
        """The state of a decode's start and the cache of ``z``."""
        self.labels.fill_(LABEL_OUTPUT)
        self.labels[:, 0] = LABEL_START
        self.labels[:, 1] = LABEL_INPUT
        self.adj.zero_()
        self.adj[:, 0, 1] = 1.0
        self.reach.copy_(self.adj)
        self.finished.zero_()
        self.used.zero_()
        self.cache = model.decode_memory(self.z)

    def step(self, model: PaceVAE, idx: int) -> None:
        """Slot ``idx``'s model step: its type logits and edge probabilities."""
        self.logits = model.decode_step_cached(self.cache, self.labels, self.adj, self.reach, idx)

    def draw(self, idx: int) -> None:
        """Slot ``idx``'s draw from its logits and the uniforms ``u_type``,
        ``u_edge``: its label, its in-edges, its ancestors, and the state."""
        type_logits, edge_probs = self.logits
        n, slot, finished = self.n, self.slot, self.finished
        if self.constrain_labels:
            last = idx == n - 1
            disallow = self.virtual | (~self.is_output_label if last else self.is_output_label)
            disallow = disallow[None, :]
            if self.mask_used:
                disallow = disallow | self.used
            type_logits = type_logits.masked_fill(disallow, torch.finfo(type_logits.dtype).min)

        if self.hard:
            sampled = torch.argmax(type_logits, dim=-1)
        else:
            # Gumbel-max draw, as jax.random.categorical.  u in [0, 1) keeps
            # -log(u) > 0; finfo.min / T is -inf, which the argmax never
            # picks while a finite logit exists.
            gumbel = -torch.log(-torch.log(self.u_type))
            sampled = torch.argmax(type_logits * self.inv_t + gumbel, dim=-1)
        sampled = sampled.to(torch.int32)
        is_output = sampled == LABEL_OUTPUT
        new_label = torch.full_like(sampled, LABEL_OUTPUT) if idx == n - 1 else sampled
        self.labels[:, idx] = torch.where(finished, self.labels[:, idx], new_label)

        parent_ok = (slot >= 1) & (slot <= idx - 1)
        if self.hard:
            bern = edge_probs > 0.5
        else:
            p = edge_probs.clamp(1e-6, 1.0 - 1e-6)
            sharpened = torch.sigmoid((torch.log(p) - torch.log1p(-p)) * self.inv_t)
            bern = self.u_edge < sharpened
        sampled_edges = bern & parent_ok[None, :]

        if self.max_in_degree is not None:
            # Keep at most max_in_degree REAL parents (slots >= 2); the
            # stable double argsort breaks probability ties by slot index.
            real_sampled = sampled_edges & (slot >= 2)[None, :]
            neg = torch.where(real_sampled, -edge_probs, torch.inf)
            rank = torch.argsort(torch.argsort(neg, dim=-1, stable=True), dim=-1, stable=True)
            kept = real_sampled & (rank < self.max_in_degree)
            sampled_edges = kept | (sampled_edges & (slot < 2)[None, :])

        sinks = (self.adj.sum(dim=-1) == 0) & (slot < idx)[None, :]
        new_col = torch.where(is_output[:, None], sinks, sampled_edges)
        new_col = new_col & ~finished[:, None]
        col_f = new_col.to(torch.float32)
        self.adj[:, :, idx] = col_f

        # ancestors(idx) = parents U ancestors(parents)
        anc = torch.clamp(col_f + (self.reach @ col_f[..., None])[..., 0], 0.0, 1.0)
        self.reach[:, :, idx] = anc

        self.used |= (new_label[:, None] == self.labels_range) & ~finished[:, None]
        self.finished |= is_output

    def capture(self, model: PaceVAE, generator: Optional[torch.Generator]):
        """:meth:`run` for the call that first meets the workspace on a CUDA
        device.  Its decode runs directly on the capture stream, so that
        every kernel is loaded and the libraries hold their workspaces for
        that stream before a capture; then its cache is freed and the
        allocator's cache released, so that the graphs' pool finds that
        memory, and the memory and each slot's step and draw are captured as
        CUDA graphs, in the order calls replay them, into one pool.  A
        capture runs nothing; a replay runs its graph's kernels without
        their wrappers, so no wrapper counts them."""
        device = self.z.device
        if device not in _capture_streams:
            _capture_streams[device] = torch.cuda.Stream(device)
        main, stream = torch.cuda.current_stream(device), _capture_streams[device]
        stream.wait_stream(main)
        try:
            with torch.cuda.stream(stream):
                self._decode(model, generator)
                self.cache = self.logits = None
                torch.cuda.empty_cache()
                pool = torch.cuda.graph_pool_handle()
                memory = _captured(lambda: self.memory(model), pool)
                slots = [(_captured(lambda: self.step(model, idx), pool),
                          _captured(lambda: self.draw(idx), pool))
                         for idx in range(2, self.n)]
        finally:
            main.wait_stream(stream)
        self.graphs = (memory, slots)
        return self._outputs()

    def run(self, model: PaceVAE, generator: Optional[torch.Generator]):
        """One decode of the loaded latents, its graphs replayed where it has
        them: (labels, adj, finished), copied out of the workspace."""
        self._decode(model, generator)
        return self._outputs()

    def _outputs(self):
        return self.labels.clone(), self.adj.clone(), self.finished.clone()

    def _decode(self, model: PaceVAE, generator: Optional[torch.Generator]) -> None:
        batch = self.z.shape[0]
        memory, slots = self.graphs if self.graphs is not None else (None, None)
        with profiling.span("decode.memory", device=True):
            if memory is None:
                self.memory(model)
            else:
                memory.replay()
        profiling.count("decode.rows", batch)
        built = 0
        for idx in range(2, self.n):
            # the positions built since the last slot go through the decoder
            profiling.count("decode.positions", batch * (idx - built))
            built = idx
            with profiling.span("decode.model", device=True):
                if slots is None:
                    self.step(model, idx)
                else:
                    slots[idx - 2][0].replay()
            with profiling.span("decode.draw"):
                if not self.hard:
                    torch.rand(self.u_type.shape, generator=generator, out=self.u_type)
                    torch.rand(self.u_edge.shape, generator=generator, out=self.u_edge)
                if slots is None:
                    self.draw(idx)
                else:
                    slots[idx - 2][1].replay()


def _captured(fn, pool) -> "torch.cuda.CUDAGraph":
    """``fn``'s work on the current stream as a CUDA graph in ``pool`` (no
    synchronisation and no cache release around it, unlike
    ``torch.cuda.graph``: a decode captures tens of graphs in a row)."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        fn()
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass  # the capture that fn's error broke; fn's error is the one to see
        raise
    graph.capture_end()
    return graph


def decode_to_labeled(
    model: PaceVAE,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    constrain_labels: bool = True,
    temperature: float = 1.0,
    max_in_degree: Optional[int] = None,
) -> Tuple[DagBatch, torch.Tensor]:
    """Decode latents to labeled DAGs and a validity mask (unwrapped labels
    all within the real cardinality; edges point forward by construction)."""
    with profiling.span("decode"):
        labels, adj, _ = sample_decode(
            model, z, generator, constrain_labels, temperature, max_in_degree
        )
        with profiling.span("decode.unwrap"):
            unwrapped = pace_unwrap(labels, adj)
            valid = is_valid_labeled(unwrapped.labels, unwrapped.adj,
                                     model.real_label_cardinality)
    return unwrapped, valid
