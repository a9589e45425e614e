"""The port's DAG drawing: the layered layout equals the JAX package's
(numpy in both, compared exactly), and the three-panel demo writes a PNG
from a port model on the CPU."""

import numpy as np
import pytest
import torch

from dags_vae_search_tpu.utils import viz as jviz
from dags_vae_search_tpu_torch.models.pace_vae import make_model
from dags_vae_search_tpu_torch.utils import viz as tviz


@pytest.mark.parametrize("n,density,seed", [(1, 0.0, 0), (8, 0.3, 1), (20, 0.15, 2), (37, 0.08, 3),
                                            (12, 0.0, 4)])
def test_layered_layout_equals_jax(n, density, seed):
    adj = np.triu(np.random.default_rng(seed).random((n, n)) < density, 1).astype(np.float32)
    got = tviz.layered_layout(adj)
    np.testing.assert_array_equal(got, jviz.layered_layout(adj))
    assert got.shape == (n, 2)


def test_draw_examples_writes_a_png(tmp_path):
    model = make_model(0, "cpu", num_real_vertices=6, real_label_cardinality=6, embed_size=8,
                       num_heads=2, num_layers=1, latent_size=8, fc_hidden=8)
    labels = np.random.default_rng(0).permutation(6).astype(np.int32)
    adj = np.triu(np.ones((6, 6), np.float32), 1) * (np.arange(6)[None, :] % 2)
    out = tmp_path / "demo.png"
    got = tviz.draw_examples(model, labels, adj, torch.Generator().manual_seed(3),
                             out_path=str(out), naming={0: "asia"})
    assert got == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
