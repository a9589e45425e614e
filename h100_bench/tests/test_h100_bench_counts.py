"""The work counts of the per-layer metrics against hand counts at tiny
configurations, and the training count against torch's FLOP counter run
over the reference's forward pass."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import harness, peaks
from h100_bench.reference import pace

TINY = {"num_vertices": 2, "label_cardinality": 2,
        "model": {"embed_size": 2, "num_heads": 1, "num_layers": 1, "latent_size": 3,
                  "fc_hidden": 2, "dropout": 0.0, "beta": 0.005, "epsilon_scale": 0.01,
                  "loss_variant": "v3", "edge_readout": False, "edge_readout_rank": 0}}


def metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_decode_flops_by_hand():
    # N = 5 slots, 5 labels, E = 2, d = 4, latent 3, fc_hidden 2, 1 layer.
    # Once a candidate: fc3 2*3*5*4 = 120; the memory's keys and values
    # 2 * (2*5*4*4) = 320.  Slot idx (2..4), attending idx positions:
    # features 2*5*2 + 2*10*4 + 2*4*2 = 116; the layer 4*2*16 + 4*idx*4
    # (self) + 2*2*16 + 4*idx*4 (cross) + 2*2*16 (FFN) = 256 + 32 idx;
    # heads 2*4*2 + 2*2*5 + 2*2*16 + (idx - 1)*4*4 = 100 + 16 (idx - 1).
    # Sum over idx = 2, 3, 4: 3 * (116 + 256 + 100 - 16) + 48 * 9 = 1800.
    assert metric("search_mfu").decode_flops(TINY) == 440 + 1800


def test_decode_flops_with_the_edge_readouts():
    full = {**TINY, "model": {**TINY["model"], "edge_readout": True}}
    assert metric("search_mfu").decode_flops(full) == 2240 + 2 * 3 * 4 * 4
    ranked = {**TINY, "model": {**TINY["model"], "edge_readout": True, "edge_readout_rank": 2}}
    assert metric("search_mfu").decode_flops(ranked) == 2240 + 2 * 2 * 3 * 4 * 2 + 2 * 4 * 4 * 2


@pytest.mark.parametrize("readout,rank", [(False, 0), (True, 0), (True, 2)])
def test_train_forward_flops_match_the_counter(readout, rank):
    cfg = {"num_vertices": 4, "label_cardinality": 4,
           "model": {**TINY["model"], "embed_size": 4, "num_heads": 2, "num_layers": 2,
                     "latent_size": 6, "fc_hidden": 3, "edge_readout": readout,
                     "edge_readout_rank": rank}}
    m = {**cfg["model"], "num_vertices": 4, "label_cardinality": 4}
    p = pace.make_weights(m, 0, "cpu")
    labels = torch.tensor([[2, 0, 3, 1]])
    adj = torch.zeros(1, 4, 4)
    adj[0, 0, 2] = adj[0, 1, 3] = 1.0
    wl, wa = pace.wrap(labels, adj)
    allowed = pace.allowed_of(wa)  # the closure is not the model's work
    c = pace.Ctx(m)
    big = wl.shape[1]
    with FlopCounterMode(display=False) as counter:
        mu, _ = pace.encode(p, wl, wa, allowed, c)
        out = pace.decode_hidden(p, mu, wl, wa, allowed, c)
        pace.node_head(p, out, c)
        pi, pj = torch.tril_indices(big - 1, big - 1, offset=-1)
        pace.edge_head(p, torch.cat([out[:, pi], out[:, pj]], dim=-1), c)
        if readout:
            pace.edge_bias(p, mu, big, c)
    assert metric("train_mfu").forward_flops(cfg) == counter.get_total_flops()


def test_climb_ops_by_hand():
    # 3 moves, each re-ranking n - 1 = 3 parent sets over 5 unique rows at
    # 1.5 + 2 operations a row
    assert metric("climb_mfu").climb_ops(3, 4, 5, 1.5) == 3 * 3 * 5 * 3.5


def test_bounds_by_hand():
    # 10 rows of 4 nodes over 7 unique rows, 12 bytes of codes, 6 filled slots
    b = peaks.score_bound(10, 4, 7, 12, 6)
    assert b["bytes"] == 10 * 4 * 4 + 12 + 7 * 4 + 10 * 4 + 4 * 4 + 10 * 4
    assert b["int_ops"] == 7 * (6 + 20)
    assert b["bound_s"] == max(b["bytes"] / 3.35e12, b["int_ops"] / (132 * 64 * 1.98e9))
    # 3 families of 2 slots, 5 nodes, 7 unique rows, 12 bytes of codes,
    # 16 bins, 4 filled slots
    f = peaks.family_bound(3, 2, 5, 7, 12, 16, 4)
    assert f["bytes"] == 3 * 3 * 4 + 5 * 4 + 12 + 7 * 4 + 3 * 16 * 4
    assert f["int_ops"] == 7 * (4 + 6)
    assert f["bound_by"] == "bytes"
    assert math.isclose(peaks.INT32_PER_S, 132 * 64 * 1.98e9)


def test_the_reference_has_each_configuration_s_parameters():
    models = 0
    for c in harness.read_json("..", "BENCHMARK.json")["configs"]:
        cfg = harness.read_json("configs", f"{c['name']}.json")
        if "model" not in cfg:  # a configuration that runs no model
            continue
        models += 1
        m = {**cfg["model"], "num_vertices": cfg["num_vertices"],
             "label_cardinality": cfg["label_cardinality"]}
        assert pace.num_parameters(m) == cfg["parameters"]
    assert models
