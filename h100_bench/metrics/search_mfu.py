"""``search_mfu``: the latent search's share of the card's float32 peak, in
%: the decoder FLOPs of the candidates the traced window decoded, over the
window, over 67 TFLOP/s.

The FLOPs of a candidate are the least a decoder needs that reuses what it
computed for earlier slots: each new position through every layer once
(projections, attention over the positions it may attend, the FFN), its
input features, its type head and its edge head (the new position's half of
the first edge layer once, then a sum, a ReLU and the output dot per
candidate parent), plus, once per candidate, the latent's memory, its keys
and values in every layer, and the edge readout.  The program's sampling
decode keeps these in a per-call key/value cache and runs only each slot's
new position, so the count follows what it runs.
"""

from h100_bench import peaks


def decode_flops(cfg: dict) -> float:
    """Decoder FLOPs of one decoded candidate (2 per multiply-add)."""
    m = cfg["model"]
    big = cfg["num_vertices"] + 3
    card = cfg["label_cardinality"] + 3
    e, lat, fh, layers = m["embed_size"], m["latent_size"], m["fc_hidden"], m["num_layers"]
    d = 2 * e
    once = 2 * lat * big * d + layers * 2 * (2 * big * d * d)
    r = m["edge_readout_rank"] if m["edge_readout"] else 0
    if m["edge_readout"]:
        once += 2 * lat * (big - 1) * (big - 1) if r == 0 else \
            2 * 2 * lat * (big - 1) * r + 2 * (big - 1) * (big - 1) * r
    total = once
    for idx in range(2, big):  # the position idx - 1 predicts slot idx
        seen = idx  # positions it may attend at most: 0 .. idx - 1
        features = 2 * card * e + 2 * (2 * big) * (2 * e) + 2 * (2 * e) * e
        layer = (4 * 2 * d * d + 2 * 2 * seen * d      # self-attention
                 + 2 * 2 * d * d + 2 * 2 * seen * d    # cross-attention (q, out; scores, values)
                 + 2 * 2 * d * d)                      # FFN
        heads = 2 * d * fh + 2 * fh * card + 2 * (2 * d * d) + (idx - 1) * 4 * d
        total += features + layers * layer + heads
    return float(total)


def read(ctx):
    done = ctx.counts.get("candidates")
    if not done or ctx.window_s <= 0:
        return None
    return 100.0 * done * decode_flops(ctx.config) / ctx.window_s / peaks.FP32_PER_S
