"""``train_mfu``: the training step's share of the card's float32 peak, in
%: 3 x the forward matrix-product FLOPs of the graphs the traced window
trained on (encoder, decoder and readout, from the configuration's shapes;
recomputation not counted), over the window, over 67 TFLOP/s.
"""

from h100_bench import peaks


def forward_flops(cfg: dict) -> float:
    """Forward matrix-product FLOPs of one graph (2 per multiply-add)."""
    m = cfg["model"]
    big = cfg["num_vertices"] + 3
    card = cfg["label_cardinality"] + 3
    e, lat, fh, layers = m["embed_size"], m["latent_size"], m["fc_hidden"], m["num_layers"]
    d = 2 * e
    features = 2 * big * card * e + 2 * big * (2 * big) * (2 * e) + 2 * big * (2 * e) * e
    attention = 4 * 2 * big * d * d + 2 * 2 * big * big * d
    ffn = 2 * 2 * big * d * d
    encoder = features + layers * (attention + ffn) + 2 * 2 * big * d * lat
    decoder = 2 * lat * big * d + features + layers * (2 * attention + ffn)
    pairs = (big - 1) * (big - 2) // 2
    heads = big * (2 * d * fh + 2 * fh * card) + pairs * (2 * (2 * d) * d + 2 * d)
    readout = 0
    if m["edge_readout"]:
        r = m["edge_readout_rank"]
        readout = 2 * lat * (big - 1) * (big - 1) if r == 0 else \
            2 * 2 * lat * (big - 1) * r + 2 * (big - 1) * (big - 1) * r
    return float(encoder + decoder + heads + readout)


def read(ctx):
    graphs = ctx.counts.get("graphs")
    if not graphs or ctx.window_s <= 0:
        return None
    return 100.0 * 3 * graphs * forward_flops(ctx.config) / ctx.window_s / peaks.FP32_PER_S
