"""Plain-PyTorch reference of the PACE DAG-VAE (Dong et al., ICML 2022) as the
configurations state it: the parameter table, seed-made weights, the
teacher-forced decoder step and the training loss with its gradients, clip
and Adam update.

It imports nothing of the program.  Parameters are a dict of float32
tensors keyed by the names the measured package gives them, so the benchmark
can load the same weights into the program and hand them here.

Precision: ``prec="fp32"`` is float32 throughout with TF32 off (the
configurations' precision); ``prec="tf32"`` takes every matrix product in
TF32 (the control's precision): on the card by its TF32 tensor-core path,
elsewhere by rounding the operands, and the gradients' operands, to TF32's
10-bit mantissa with float32 accumulation.

Dropout draws its masks from the generator handed in, one
``bernoulli_`` per dropout site in the order the forward pass reaches them,
and the reparameterisation noise one ``randn``: a seeded training step
draws the same masks as the program when both take the same stream.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LABEL_INPUT, LABEL_OUTPUT, LABEL_START = 0, 1, 2
NUM_VIRTUAL = 3


def exact_matmul() -> None:
    """Float32 products without TF32, whatever the process set before."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest on TF32's 10-bit mantissa (as float32)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    while x.dim() > len(shape):
        x = x.sum(0)
    for i, size in enumerate(shape):
        if size == 1 and x.shape[i] != 1:
            x = x.sum(i, keepdim=True)
    return x


class _TF32MatMul(torch.autograd.Function):
    """A product with its operands, and its gradients' operands, rounded to
    TF32 and float32 accumulation: TF32 where the card does not do it."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = (a.shape, b.shape)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        ga = _sum_to(rg @ rb.transpose(-1, -2), ctx.shapes[0])
        gb = _sum_to(ra.transpose(-1, -2) @ rg, ctx.shapes[1])
        return ga, gb


class tf32_products:
    """Within the block, CUDA float32 products (forward and backward) run in
    TF32 when ``on``, else in full float32."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return a @ b
    if prec != "tf32":
        raise ValueError(f"unknown precision {prec!r}")
    if a.is_cuda:
        with tf32_products(True):
            return a @ b
    return _TF32MatMul.apply(a, b)


# ---------------------------------------------------------------- parameters


def param_table(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, bound) of every parameter of model settings ``m``
    (a configuration's ``model`` group plus ``num_vertices`` and
    ``label_cardinality``).  init: 'uniform' in [-bound, bound], 'ones',
    'zeros'.  Dense layers take torch's default bound 1/sqrt(fan_in), the
    positional weights xavier-uniform with gain sqrt(2)."""
    n = m["num_vertices"] + NUM_VIRTUAL
    card = m["label_cardinality"] + NUM_VIRTUAL
    e = m["embed_size"]
    d = 2 * e
    lat, fh, layers = m["latent_size"], m["fc_hidden"], m["num_layers"]
    out: List[Tuple[str, tuple, str, float]] = []

    def dense(name, fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        out.append((f"{name}.weight", (fan_out, fan_in), "uniform", bound))
        out.append((f"{name}.bias", (fan_out,), "uniform", bound))

    def norm(name):
        out.append((f"{name}.weight", (d,), "ones", 0.0))
        out.append((f"{name}.bias", (d,), "zeros", 0.0))

    def attention(name):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{name}.{proj}", d, d)

    for name, shape in (("pos_w1", (2 * n, 2 * e)), ("pos_w2", (2 * e, e))):
        bound = math.sqrt(2.0) * math.sqrt(6.0 / (shape[0] + shape[1]))
        out.append((name, shape, "uniform", bound))
    dense("label_embed", card, e)
    for i in range(layers):
        pre = f"encoder.layer{i}"
        attention(f"{pre}.self_attn")
        norm(f"{pre}.norm1")
        dense(f"{pre}.linear1", d, d)
        dense(f"{pre}.linear2", d, d)
        norm(f"{pre}.norm2")
    dense("fc1", n * d, lat)
    dense("fc2", n * d, lat)
    dense("fc3", lat, n * d)
    for i in range(layers):
        pre = f"decoder.layer{i}"
        attention(f"{pre}.self_attn")
        norm(f"{pre}.norm1")
        attention(f"{pre}.cross_attn")
        norm(f"{pre}.norm2")
        dense(f"{pre}.linear1", d, d)
        dense(f"{pre}.linear2", d, d)
        norm(f"{pre}.norm3")
    dense("add_node_hidden", d, fh)
    dense("add_node_out", fh, card)
    dense("add_edge_hidden", 2 * d, d)
    dense("add_edge_out", d, 1)
    if m["edge_readout"]:
        r = m["edge_readout_rank"]
        if r > 0:
            dense("edge_readout_u", lat, (n - 1) * r)
            dense("edge_readout_v", lat, (n - 1) * r)
        else:
            dense("edge_readout_fc", lat, (n - 1) * (n - 1))
    return out


def num_parameters(m: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in param_table(m))


def make_weights(m: dict, seed: int, device, overrides: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from ``seed`` on ``device`` in one call: one flat
    uniform [-1, 1) draw from a ``torch.Generator`` there, scaled leaf by
    leaf by one broadcast multiply, LayerNorms ones and zeros.
    ``overrides`` maps a name to a constant fill (an assumed stand-in for a
    trained value, stated in the configuration)."""
    table = param_table(m)
    drawn = [(name, shape, bound) for name, shape, init, bound in table if init == "uniform"]
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    bounds = torch.tensor([b for _, _, b in drawn], device=device)
    flat *= torch.repeat_interleave(bounds, torch.tensor(sizes, device=device))
    weights: Dict[str, torch.Tensor] = {}
    for (name, shape, _), part in zip(drawn, torch.split(flat, sizes)):
        weights[name] = part.view(shape)
    for name, shape, init, _ in table:
        if init == "ones":
            weights[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            weights[name] = torch.zeros(shape, device=device)
    for name, value in (overrides or {}).items():
        weights[name] = torch.full_like(weights[name], float(value))
    return {name: weights[name] for name, _, _, _ in table}


# ------------------------------------------------------------------- graphs


def closure(adj: torch.Tensor) -> torch.Tensor:
    """bool reachability by paths of length >= 1 (repeated squaring)."""
    reach = adj > 0
    n = adj.shape[-1]
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        r = reach.to(torch.float32)
        reach = reach | ((r @ r) > 0)
    return reach


def wrap(labels: torch.Tensor, adj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PACE wrapping: start, input, the real slots (labels + 3), output;
    edges start->input, input->sources, the real ones, sinks->output."""
    b, n = labels.shape
    big = n + NUM_VIRTUAL
    dev = labels.device
    wl = torch.empty((b, big), dtype=torch.long, device=dev)
    wl[:, 0], wl[:, 1], wl[:, -1] = LABEL_START, LABEL_INPUT, LABEL_OUTPUT
    wl[:, 2:n + 2] = labels.long() + NUM_VIRTUAL
    wa = torch.zeros((b, big, big), device=dev)
    a = (adj > 0).float()
    wa[:, 0, 1] = 1.0
    wa[:, 2:n + 2, 2:n + 2] = a
    wa[:, 1, 2:n + 2] = (a.sum(1) == 0).float()
    wa[:, 2:n + 2, big - 1] = (a.sum(2) == 0).float()
    return wl, wa


def allowed_of(adj: torch.Tensor) -> torch.Tensor:
    """Query q attends key k iff a path k -> q, or q == k."""
    n = adj.shape[-1]
    return closure(adj).transpose(-1, -2) | torch.eye(n, dtype=torch.bool, device=adj.device)


# ------------------------------------------------------------------ network


class Ctx:
    """Precision, mode and the dropout stream of one forward pass."""

    def __init__(self, m: dict, prec: str = "fp32", gen: Optional[torch.Generator] = None,
                 train: bool = False):
        self.m, self.prec, self.gen, self.train = m, prec, gen, train
        self.rate = float(m["dropout"])

    def drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return x * torch.empty_like(x).bernoulli_(keep, generator=self.gen).div_(keep)


def linear(p, name, x, c: Ctx):
    return mm(x, p[f"{name}.weight"].t(), c.prec) + p[f"{name}.bias"]


def layer_norm(p, name, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def attention(p, name, q_in, kv_in, allowed, c: Ctx):
    b, nq, d = q_in.shape
    h = c.m["num_heads"]
    dh = d // h

    def heads(x):
        return x.reshape(b, -1, h, dh).transpose(1, 2)

    q = heads(linear(p, f"{name}.q_proj", q_in, c))
    k = heads(linear(p, f"{name}.k_proj", kv_in, c))
    v = heads(linear(p, f"{name}.v_proj", kv_in, c))
    logits = mm(q, k.transpose(-1, -2), c.prec) / math.sqrt(dh)
    logits = logits.masked_fill(~allowed[:, None], -1e30)
    w = c.drop(torch.softmax(logits, dim=-1))
    out = mm(w, v, c.prec).transpose(1, 2).reshape(b, nq, d)
    return linear(p, f"{name}.out_proj", out, c)


def features(p, labels, adj, c: Ctx):
    """Label embedding beside the positional encoding of [I | A^T]."""
    b, n = labels.shape
    card = c.m["label_cardinality"] + NUM_VIRTUAL
    one_hot = F.one_hot(labels.long(), card).float()
    emb = torch.relu(linear(p, "label_embed", one_hot, c))
    eye = torch.eye(n, device=adj.device).expand(b, n, n)
    x = torch.cat([eye, adj.transpose(-1, -2)], dim=-1)
    hid = c.drop(torch.relu(mm(x, p["pos_w1"], c.prec)))
    pos = c.drop(mm(hid, p["pos_w2"], c.prec))
    return torch.cat([emb, pos], dim=-1)


def encode(p, labels, adj, allowed, c: Ctx):
    x = features(p, labels, adj, c)
    for i in range(c.m["num_layers"]):
        pre = f"encoder.layer{i}"
        x = layer_norm(p, f"{pre}.norm1", x + c.drop(attention(p, f"{pre}.self_attn", x, x, allowed, c)))
        ff = linear(p, f"{pre}.linear2", c.drop(torch.relu(linear(p, f"{pre}.linear1", x, c))), c)
        x = layer_norm(p, f"{pre}.norm2", x + c.drop(ff))
    flat = x.reshape(x.shape[0], -1)
    return linear(p, "fc1", flat, c), linear(p, "fc2", flat, c)


def decode_hidden(p, z, labels, adj, allowed, c: Ctx):
    b, n = labels.shape
    memory = linear(p, "fc3", z, c).reshape(b, n, -1)
    x = features(p, labels, adj, c)
    for i in range(c.m["num_layers"]):
        pre = f"decoder.layer{i}"
        x = layer_norm(p, f"{pre}.norm1", x + c.drop(attention(p, f"{pre}.self_attn", x, x, allowed, c)))
        x = layer_norm(p, f"{pre}.norm2",
                       x + c.drop(attention(p, f"{pre}.cross_attn", x, memory, allowed, c)))
        ff = linear(p, f"{pre}.linear2", c.drop(torch.relu(linear(p, f"{pre}.linear1", x, c))), c)
        x = layer_norm(p, f"{pre}.norm3", x + c.drop(ff))
    return x


def node_head(p, h, c: Ctx):
    return linear(p, "add_node_out", torch.relu(linear(p, "add_node_hidden", h, c)), c)


def edge_head(p, pair, c: Ctx):
    return linear(p, "add_edge_out", torch.relu(linear(p, "add_edge_hidden", pair, c)), c)[..., 0]


def edge_bias(p, z, n, c: Ctx):
    """z -> per-pair edge-logit bias [B, n-1, n-1] (row = child position,
    column = parent position)."""
    r = c.m["edge_readout_rank"]
    if r > 0:
        u = linear(p, "edge_readout_u", z, c).reshape(-1, n - 1, r)
        v = linear(p, "edge_readout_v", z, c).reshape(-1, n - 1, r)
        return mm(u, v.transpose(1, 2), c.prec) / math.sqrt(r)
    return linear(p, "edge_readout_fc", z, c).reshape(-1, n - 1, n - 1)


def decode_step(p, z, labels, adj, allowed, idx: int, c: Ctx):
    """Type logits [B, L] and parent-edge probabilities [B, N] (by parent
    slot) of slot ``idx`` given the state before it."""
    out = decode_hidden(p, z, labels, adj, allowed, c)
    h_new = out[:, idx - 1]
    type_logits = node_head(p, h_new, c)
    parent_hidden = torch.roll(out, 1, dims=1)
    pair = torch.cat([h_new[:, None, :].expand_as(parent_hidden), parent_hidden], dim=-1)
    edge_logits = edge_head(p, pair, c)
    if c.m["edge_readout"]:
        n = labels.shape[-1]
        row = F.pad(edge_bias(p, z, n, c)[:, idx - 1], (0, 1))
        edge_logits = edge_logits + torch.roll(row, 1, dims=-1)
    return type_logits, torch.sigmoid(edge_logits)


def loss(p, labels, adj, c: Ctx):
    """(total, recon, kld) summed over the batch of labelled DAGs, the
    variant-3 loss (node NLL + edge BCE with logits + beta * KL)."""
    wl, wa = wrap(labels, adj)
    allowed = allowed_of(wa)
    n = wl.shape[1]
    mu, logvar = encode(p, wl, wa, allowed, c)
    if c.train:
        eps = torch.randn(mu.shape, generator=c.gen, device=mu.device)
        z = mu + eps * float(c.m["epsilon_scale"]) * torch.exp(0.5 * logvar)
    else:
        z = mu
    out = decode_hidden(p, z, wl, wa, allowed, c)
    node_logp = torch.log_softmax(node_head(p, out, c), dim=-1)
    card = c.m["label_cardinality"] + NUM_VIRTUAL
    targets = F.one_hot(wl[:, 1:], card).float()
    node_ll = (node_logp[:, : n - 1] * targets).sum()
    pi, pj = torch.tril_indices(n - 1, n - 1, offset=-1, device=wl.device)
    logits = edge_head(p, torch.cat([out[:, pi], out[:, pj]], dim=-1), c)
    if c.m["edge_readout"]:
        logits = logits + edge_bias(p, z, n, c)[:, pi, pj]
    t = wa[:, pj + 1, pi + 1]
    edge_ll = (t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits)).sum()
    recon = -(node_ll + edge_ll)
    kld = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar))
    return recon + float(c.m["beta"]) * kld, recon, kld


# ---------------------------------------------------------------- training


class Adam:
    """Global-norm clip (scale by clip / norm once the norm reaches it) and
    bias-corrected Adam (betas 0.9 / 0.999, eps 1e-8), in plain tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, clip: float):
        self.lr, self.clip = lr, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Returns the clipped gradients it applied."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = self.clip / norm if float(norm) >= self.clip else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1**self.t)
            v_hat = self.v[k] / (1 - b2**self.t)
            params[k] = params[k] - self.lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        return grads


def train_steps(p0, batches, m: dict, lr: float, clip: float, gen: torch.Generator,
                prec: str = "fp32", batch_fraction: float = 1.0, moments=None):
    """Follows ``len(batches)`` training steps from weights ``p0``: returns
    (losses [steps, 3], the first clipped gradient, the weights after the
    last step).  ``moments`` (first and second moments by leaf, the steps
    taken) starts Adam from that state in place of fresh moments.
    ``batch_fraction`` < 1 is a fault for the control: the step sees only
    the leading share of each batch and scales its loss to the whole
    batch."""
    params = {k: v.detach().clone() for k, v in p0.items()}
    opt = Adam(params, lr, clip)
    if moments is not None:
        first_m, second_m, opt.t = moments
        opt.m = {k: first_m[k].to(params[k].device).clone() for k in params}
        opt.v = {k: second_m[k].to(params[k].device).clone() for k in params}
    losses, first = [], None
    for labels, adj in batches:
        keep = max(1, int(round(labels.shape[0] * batch_fraction)))
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, recon, kld = loss(leaves, labels[:keep], adj[:keep], Ctx(m, prec, gen, train=True))
        scale = labels.shape[0] / keep
        with tf32_products(prec == "tf32"):
            (total * scale).backward()
        grads = {k: v.grad for k, v in leaves.items()}
        applied = opt.step(params, grads)
        if first is None:
            first = {k: g.detach() for k, g in applied.items()}
        losses.append(torch.stack([total, recon, kld]).detach() * scale)
    return torch.stack(losses), first, params
