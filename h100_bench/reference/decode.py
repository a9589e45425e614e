"""Plain-PyTorch judge of the sampling decode (PACE's autoregressive decode
with Gumbel-max node types, Bernoulli parent edges, temperature sharpening
and the in-degree cap), teacher-forced on what the program emitted.

The decode draws, slot by slot, one uniform ``[B, L]`` for the node types
and one ``[B, N]`` for the edges from the generator it is handed.  Given that
generator's state at the call, the same shapes draw the same numbers here,
so every decision of a sampled row can be remade from the reference's own
logits.  A decision that differs from the reference's is scored by how far
the reference is from making it (its gap); a sound program differs only
where the reference is within rounding of a tie.

Rules of a slot ``idx`` (2 <= idx < N), for a row not yet finished:
- the node type is ``argmax(logits / T + gumbel(u))`` over the allowed
  labels (no virtual label; the output label only at the last slot; no
  label used before, as labels are permutations);
- a drawn output type finishes the row, and the slot's parents are then
  every current sink among the built slots;
- otherwise parent slot p (1 <= p < idx) is drawn when
  ``u < sigmoid(logit(clamp(prob)) / T)``, and of the drawn real parents
  (p >= 2) the ``max_in_degree`` most probable are kept (ties by slot).
A finished row keeps the output label and no new edge.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from h100_bench.reference import pace

BIG = 1e9


def _slot_state(labels, adj, idx):
    """The state before slot ``idx``: later labels at the output fill,
    later columns empty."""
    lab = labels.clone()
    lab[:, idx:] = pace.LABEL_OUTPUT
    a = adj.clone()
    a[:, :, idx:] = 0.0
    return lab, a


def decode_gap(p, m: dict, calls: List[dict], control: Optional[str] = None) -> float:
    """The widest gap of a type or edge decision, over the sampled rows of
    ``calls``.  Each call holds ``state`` (the generator state at the call),
    ``batch`` (rows drawn for), ``rows`` (the sampled row indices), ``z``
    [R, nz], ``labels`` [R, N] and ``adj`` [R, N, N] (the wrapped emitted
    sequences), ``temperature`` and ``max_in_degree``.

    The emitted decisions are judged; with ``control`` ('tf32') those that
    logits at that precision make at the same positions instead (the
    control, which needs no decode of its own).  The gap is always read on
    float32 logits."""
    type_gap, edge_gap = 0.0, 0.0
    if not calls:
        return BIG
    dev = calls[0]["z"].device
    card = m["label_cardinality"] + pace.NUM_VIRTUAL
    u_types, u_edges, inv_ts = [], [], []
    for call in calls:
        gen = torch.Generator(device=dev)
        gen.set_state(call["state"])
        rows = call["rows"].to(dev)
        big = call["labels"].shape[1]
        ut, ue = [], []
        for _ in range(2, big):
            ut.append(torch.rand((call["batch"], card), generator=gen, device=dev)[rows])
            ue.append(torch.rand((call["batch"], big), generator=gen, device=dev)[rows])
        u_types.append(torch.stack(ut, 1))
        u_edges.append(torch.stack(ue, 1))
        inv_ts.append(torch.full((len(rows), 1), 1.0 / max(float(call["temperature"]), 1e-3),
                                 device=dev))
    u_type_all, u_edge_all = torch.cat(u_types), torch.cat(u_edges)
    inv_t = torch.cat(inv_ts)
    z = torch.cat([c["z"] for c in calls])
    labels = torch.cat([c["labels"] for c in calls]).long()
    adj = torch.cat([c["adj"] for c in calls])
    k_max = calls[0]["max_in_degree"]
    r, big = labels.shape
    finished = torch.zeros(r, dtype=torch.bool, device=dev)
    used = torch.zeros((r, card), dtype=torch.bool, device=dev)
    slot = torch.arange(big, device=dev)
    lr = torch.arange(card, device=dev)
    virtual = (lr == pace.LABEL_START) | (lr == pace.LABEL_INPUT)
    for idx in range(2, big):
        u_type, u_edge = u_type_all[:, idx - 2], u_edge_all[:, idx - 2]
        lab, a = _slot_state(labels, adj, idx)
        built = slot < idx
        core = pace.closure(a).transpose(-1, -2) | torch.eye(big, dtype=torch.bool, device=dev)
        allowed = (core & built[:, None] & built[None, :]) | (~built[:, None] & ~built[None, :])
        ref = pace.Ctx(m, "fp32")
        logits, probs = pace.decode_step(p, z, lab, a, allowed, idx, ref)
        if control:
            low_logits, low_probs = pace.decode_step(p, z, lab, a, allowed, idx,
                                                     pace.Ctx(m, control))
        last = idx == big - 1
        disallow = virtual | ((lr != pace.LABEL_OUTPUT) if last else (lr == pace.LABEL_OUTPUT))
        disallow = disallow[None, :] | used
        gumbel = -torch.log(-torch.log(u_type))
        score = torch.where(disallow, -math.inf, logits * inv_t + gumbel)
        live = ~finished
        served = (torch.full((r,), pace.LABEL_OUTPUT, device=dev) if last
                  else labels[:, idx])
        chosen = served
        if control:
            chosen = torch.argmax(torch.where(disallow, -math.inf, low_logits * inv_t + gumbel),
                                  dim=-1)
        best = score.max(dim=-1).values
        at = score.gather(1, chosen[:, None].long())[:, 0]
        gap_t = torch.where(live, best - at, torch.zeros((), device=dev))
        gap_t = torch.nan_to_num(gap_t, nan=BIG, posinf=BIG)
        type_gap = max(type_gap, float(gap_t.max()))

        # the slot's column as the reference makes it after the served
        # type: the sinks when it is the output label, else the draws
        is_out = served == pace.LABEL_OUTPUT
        sinks = (a.sum(-1) == 0) & built[None, :]

        def edges(pr):
            pc = pr.clamp(1e-6, 1.0 - 1e-6)
            x = (torch.log(pc) - torch.log1p(-pc)) * inv_t
            v = torch.log(u_edge) - torch.log1p(-u_edge)
            ok = (slot >= 1) & (slot <= idx - 1)
            bern = (v < x) & ok[None, :]
            real = bern & (slot >= 2)[None, :]
            neg = torch.where(real, -pr, torch.inf)
            rank = torch.argsort(torch.argsort(neg, dim=-1, stable=True), dim=-1, stable=True)
            kept = (real & (rank < k_max)) | (bern & (slot < 2)[None, :])
            return kept, x - v

        ref_col, margin = edges(probs)
        want = torch.where(is_out[:, None], sinks, ref_col) & live[:, None]
        if control:
            col = torch.where(is_out[:, None], sinks, edges(low_probs)[0]) & live[:, None]
        else:
            col = adj[:, :, idx] > 0
        differ = col != want
        # how far the reference is from the emitted decision: the
        # Bernoulli's margin, or the cap's (this parent's logit against
        # the k-th kept one's), whichever is nearer
        real_ref = (margin > 0) & (slot >= 2)[None, :] & (slot <= idx - 1)[None, :]
        pr = probs.clamp(1e-30, 1.0 - 1e-7)
        lp = torch.log(pr) - torch.log1p(-pr)
        lp_real = torch.where(real_ref, lp, -torch.inf)
        kth = torch.topk(lp_real, min(k_max, big), dim=-1).values[:, -1:]
        capped = real_ref.sum(-1, keepdim=True) > k_max
        cap_margin = torch.where(capped, (lp - kth).abs(), torch.inf)
        near = torch.minimum(margin.abs(), cap_margin)
        exact = (is_out | finished)[:, None]
        near = torch.where(exact, torch.full_like(near, BIG), near)
        gap_e = torch.where(differ, near, torch.zeros((), device=dev))
        edge_gap = max(edge_gap, float(torch.nan_to_num(gap_e, nan=BIG, posinf=BIG).max()))

        used = used | (torch.nn.functional.one_hot(served.long(), card).bool() & live[:, None])
        finished = finished | (is_out & live)
    return max(type_gap, edge_gap)

