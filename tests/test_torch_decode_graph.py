"""The sampling decode's workspace (``models/decode.py::DecodeWorkspace``) on
the CPU, where its memory, step and draw functions are called directly: the
same functions a CUDA device captures as graphs and replays
(``tests/test_torch_gpu.py`` holds the replays to these calls bit for bit).

- a workspace used for call after call decodes as the recomputing decode
  (``decode_step``) does, bit for bit;
- 1 / T as a 0-d float32 tensor multiplies as the Python scalar does;
- the workspace's key changes with each input a graph bakes in; a model
  keeps no more than ``MAX_WORKSPACES`` workspaces, the least recently used
  dropped first, and they go with it; a CPU decode keeps none.
"""

import gc
from weakref import WeakKeyDictionary

import pytest
import torch
from test_torch_decode_cache import CAP, READOUTS, SMALL, _recompute_decode

from dags_vae_search_tpu_torch.models import decode as tdecode
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.utils import profiling


@pytest.fixture
def fresh_workspaces(monkeypatch):
    workspaces = WeakKeyDictionary()
    monkeypatch.setattr(tdecode, "_workspaces", workspaces)
    return workspaces


def _model(**kwargs):
    return tvae.make_model(0, "cpu", **{**SMALL, **kwargs}).eval()


def _z(batch, seed, model):
    return torch.randn(batch, model.latent_size, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("temperature", [1.0, 0.25, 0.1])
@pytest.mark.parametrize("readout", sorted(READOUTS))
def test_a_kept_workspace_decodes_as_the_recomputing_decode(fresh_workspaces, readout,
                                                            temperature):
    """Two calls in a row through one workspace (as a CUDA device keeps it),
    other latents and generators, and the decode's own call: each equals the
    recomputing decode (1 / T a Python scalar there), and leaves the
    generator where the recomputing decode does."""
    model = _model(**READOUTS[readout])
    ws = tdecode.DecodeWorkspace(model, 24, torch.device("cpu"), True, temperature, CAP)
    for call in range(2):
        z = _z(24, 10 + call, model)
        gens = [torch.Generator().manual_seed(20 + call) for _ in range(3)]
        with torch.no_grad():
            want = _recompute_decode(model, z, gens[0], temperature)
            ws.load(z, temperature)
            kept = ws.run(model, gens[1])
        got = tdecode.sample_decode(model, z, gens[2], temperature=temperature, max_in_degree=CAP)
        for k, g, w in zip(kept, got, want):
            assert torch.equal(k, w) and torch.equal(g, w)
        assert all(torch.equal(g.get_state(), gens[0].get_state()) for g in gens[1:])
    assert len(fresh_workspaces) == 0


def test_a_workspace_of_its_own_runs_as_the_decode(fresh_workspaces):
    """A workspace made and run by its caller (as a measurement that holds
    each launch makes one) gives the decode's output, and the output is a
    copy that the workspace's next call does not touch."""
    model = _model(edge_readout=True)
    z = _z(16, 1, model)
    got = tdecode.sample_decode(model, z, torch.Generator().manual_seed(2), max_in_degree=CAP)
    ws = tdecode.DecodeWorkspace(model, 16, z.device, True, 1.0, CAP)
    ws.load(z, 1.0)
    with torch.no_grad():
        own = ws.run(model, torch.Generator().manual_seed(2))
    for g, o in zip(got, own):
        assert torch.equal(g, o)
    kept = [t.clone() for t in own]
    ws.load(_z(16, 3, model), 1.0)
    with torch.no_grad():
        ws.run(model, torch.Generator().manual_seed(4))
    for o, k in zip(own, kept):
        assert torch.equal(o, k)
    assert own[0].data_ptr() != ws.labels.data_ptr()
    assert len(fresh_workspaces) == 0


@pytest.mark.parametrize("temperature", [1.0, 0.7, 0.25, 0.1, 3e-3, 1e-3, 1e-4, 3.0, 0.123456789])
def test_inv_t_as_a_tensor_has_the_python_scalar_s_bits(temperature):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 10.0 ** torch.randint(-6, 6, (4096,), generator=g)
    p = torch.rand(4096, generator=g).clamp(1e-6, 1.0 - 1e-6)
    scalar = 1.0 / max(temperature, 1e-3)
    ws = tdecode.DecodeWorkspace(_model(), 1, torch.device("cpu"), True, temperature, None)
    ws.load(torch.zeros(1, SMALL["latent_size"]), temperature)
    assert ws.inv_t.dim() == 0 and ws.inv_t.dtype == torch.float32
    assert torch.equal(x * ws.inv_t, x * scalar)
    logit = torch.log(p) - torch.log1p(-p)
    assert torch.equal(torch.sigmoid(logit * ws.inv_t), torch.sigmoid(logit * scalar))


def _key(model, batch=8, device="cpu", constrain_labels=True, temperature=1.0,
         max_in_degree=CAP):
    z = torch.empty(batch, model.latent_size, device=device)
    return tdecode.workspace_key(model, z, constrain_labels, temperature, max_in_degree)


def test_the_key_changes_with_each_input_a_graph_bakes_in():
    model = _model()
    base = _key(model)
    assert _key(model, temperature=0.25) == _key(model, temperature=0.1) == base
    assert _key(model, temperature=1e-3) == _key(model, temperature=1e-4) != base
    others = [_key(model, batch=9), _key(model, device="meta"),
              _key(model, constrain_labels=False), _key(model, max_in_degree=None),
              _key(model, max_in_degree=CAP + 1), _key(_model(num_real_vertices=8)),
              _key(_model(matmul_dtype="bfloat16")), _key(_model(num_heads=2))]
    assert len({base, *others}) == len(others) + 1

    with torch.no_grad():
        model.add_node_out.bias.add_(1.0)  # in place: read by the next replay
    assert _key(model) == base
    model.add_node_out.bias = torch.nn.Parameter(model.add_node_out.bias.clone())
    assert _key(model) != base


def test_the_key_reads_whether_used_labels_are_masked():
    assert tdecode._mask_used(_model(), True)
    assert not tdecode._mask_used(_model(), False)
    assert not tdecode._mask_used(_model(real_label_cardinality=5), True)
    assert _key(_model(real_label_cardinality=5)) != _key(_model(real_label_cardinality=5),
                                                          constrain_labels=False)


def test_at_most_max_workspaces_are_kept_least_recently_used_out(fresh_workspaces):
    """The bookkeeping a CUDA decode keeps its workspaces by
    (:func:`kept_workspace`), with stand-ins for workspaces; the card tests
    hold the decode to it."""
    model, other = _model(), _model()
    made = []

    def make():
        made.append(object())
        return made[-1]

    for key in [2, 3, 4, 5, 6, 7]:
        tdecode.kept_workspace(model, key, make)
    assert list(fresh_workspaces[model]) == [4, 5, 6, 7] and tdecode.MAX_WORKSPACES == 4
    first = fresh_workspaces[model][4]
    assert tdecode.kept_workspace(model, 4, make) is first  # used again: kept, not remade
    tdecode.kept_workspace(model, 8, make)
    assert list(fresh_workspaces[model]) == [6, 7, 4, 8] and len(made) == 7
    tdecode.kept_workspace(other, 2, make)
    assert list(fresh_workspaces[other]) == [2] and len(fresh_workspaces[model]) == 4


def test_a_model_s_workspaces_go_with_it(fresh_workspaces):
    model = _model()
    tdecode.kept_workspace(model, 1, object)
    assert len(fresh_workspaces) == 1
    del model
    gc.collect()
    assert len(fresh_workspaces) == 0


def test_a_cpu_decode_keeps_no_workspace(fresh_workspaces):
    model = _model()
    for b in (3, 5):
        tdecode.sample_decode(model, _z(b, b, model), torch.Generator().manual_seed(0))
    assert len(fresh_workspaces) == 0


def test_the_cpu_decode_counts_no_replayed_rows(fresh_workspaces):
    model = _model()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            tdecode.sample_decode(model, _z(6, 0, model), torch.Generator().manual_seed(1))
    counts = profiling.snapshot()["counts"]
    assert counts["decode.rows"] == 12
    assert counts["decode.graph_rows"] == 0
    assert "decode.graph_captures" not in counts
