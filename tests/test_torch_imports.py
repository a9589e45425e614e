"""The port and ``chip_smoke.py`` stand alone: no JAX, no flax/optax/orbax,
nothing of the JAX package, no pandas on the scoring path, and no
networkx, pandas, pyarrow or matplotlib imported when a module is (the
card's machine has none of them)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dags_vae_search_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dags_vae_search_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _module_level_roots(path: Path):
    """Roots imported by statements that run when the module is imported
    (outside every function and class body)."""
    pending = list(ast.parse(path.read_text(), filename=str(path)).body)
    while pending:
        node = pending.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        else:
            pending.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_no_optional_host_library_at_module_level(path):
    bad = sorted(set(_module_level_roots(path)) & {"networkx", "pandas", "pyarrow", "matplotlib"})
    assert not bad, f"{path.relative_to(REPO)} imports {bad} at module level"


def test_port_has_the_slice_modules():
    modules = {
        "graphs/dag.py", "graphs/sampler.py", "scoring/datasets.py", "scoring/catalog.py",
        "ops/bic_torch.py", "ops/bic_kernel.py", "ops/_build.py", "csrc/contingency_counts.cu",
        "scoring/bic.py", "utils/config.py", "experiments/registry.py",
        "models/transformer.py", "models/pace_vae.py", "models/decode.py",
        "search/latent.py", "convert.py",
        "training/data.py", "training/train.py", "training/checkpoint.py", "training/eval.py",
        "utils/debug.py", "utils/profiling.py", "graphs/nx_bridge.py",
        "ops/reachability.py", "scoring/family_table.py", "scoring/family_batch.py",
        "search/exact.py", "search/hillclimb.py", "search/delta_hillclimb.py",
        "search/islands.py", "surrogate/gp.py", "surrogate/dataset.py",
        "graphs/codec.py", "utils/viz.py", "experiments/runner.py", "experiments/results.py",
        "native/__init__.py", "native/fast_codec.cpp", "parallel/__init__.py",
        "parallel/mesh.py", "parallel/dryrun.py",
    }
    assert all((PORT / m).is_file() for m in modules)


BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "dags_vae_search_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
from dags_vae_search_tpu_torch.models.pace_vae import make_model
from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem
from dags_vae_search_tpu_torch.search.latent import cem_search
import dags_vae_search_tpu_torch.convert
import dags_vae_search_tpu_torch.experiments.registry
_, ds = make_synthetic_problem("cancer", num_cases=300)
model = make_model(0, "cpu", num_real_vertices=5, real_label_cardinality=5, embed_size=8,
                   num_heads=2, num_layers=1, latent_size=8, fc_hidden=8)
res = cem_search(model, BicScorer(ds, max_parents=2, device="cpu"), iters=2, population=16,
                 device="cpu")
assert np.isfinite(res.best_score), res
print("ok", res.best_score)
"""


def test_port_runs_a_search_without_jax_or_pandas():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


BLOCKED_TRAIN_RUN = """
import sys, tempfile
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "pyarrow", "networkx",
             "dags_vae_search_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
from dags_vae_search_tpu_torch.graphs.sampler import generate_corpus
from dags_vae_search_tpu_torch.models.pace_vae import make_model
from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem
from dags_vae_search_tpu_torch.search.latent import cem_search
from dags_vae_search_tpu_torch.training import checkpoint, data
from dags_vae_search_tpu_torch.training.eval import evaluate_corpus
from dags_vae_search_tpu_torch.training.train import TrainConfig, Trainer
import dags_vae_search_tpu_torch.graphs.nx_bridge
import dags_vae_search_tpu_torch.utils.config
labels, adj = generate_corpus(np.random.default_rng(0), 5, 5, batch_size=4, steps_limit=4,
                              density_limit=0.6, max_in_degree=2)
train, test = data.train_test_split(data.Corpus(labels, adj), 0.25, seed=0)
model = make_model(0, "cpu", num_real_vertices=5, real_label_cardinality=5, embed_size=8,
                   num_heads=2, num_layers=1, latent_size=8, fc_hidden=8, edge_readout=True)
trainer = Trainer(model, TrainConfig(batch_size=8, epochs=1, log_every=0, steps_per_call=2))
state, history = trainer.fit(trainer.init_state(0), train, log=lambda s: None)
assert np.isfinite(history[0]["loss_per_graph"]), history
with tempfile.TemporaryDirectory() as tmp:
    checkpoint.save_checkpoint(tmp, 1, {"params": model.state_dict()})
    model.load_state_dict(checkpoint.restore_params(tmp, 1, model.state_dict()))
metrics = evaluate_corpus(model, test, 4, max_batches=1)
assert metrics["valid_ratio_mode"] == 1.0, metrics
_, ds = make_synthetic_problem("cancer", num_cases=300)
res = cem_search(model, BicScorer(ds, max_parents=2, device="cpu"), iters=1, population=16,
                 device="cpu")
assert np.isfinite(res.best_score), res
print("ok", history[0]["loss_per_graph"], res.best_score)
"""


def test_port_trains_evaluates_and_searches_without_optional_libraries():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_TRAIN_RUN], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


BLOCKED_SEARCH_STAGE_RUN = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "pyarrow", "networkx",
             "dags_vae_search_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
from dags_vae_search_tpu_torch.graphs.dag import attention_allowed
from dags_vae_search_tpu_torch.models.pace_vae import make_model
from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.catalog import make_synthetic_problem
from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
from dags_vae_search_tpu_torch.scoring.family_table import FamilyTableScorer
from dags_vae_search_tpu_torch.search import exact, hillclimb, islands, latent
from dags_vae_search_tpu_torch.search.delta_hillclimb import delta_hill_climb
from dags_vae_search_tpu_torch.surrogate.dataset import build_predictor_dataset
from dags_vae_search_tpu_torch.surrogate.gp import SGPR, ExactGP
assert attention_allowed(torch.zeros(1, 260, 260)).all(dim=-1).sum() == 0
_, ds = make_synthetic_problem("cancer", num_cases=300)
scorer = BicScorer(ds, max_parents=2, device="cpu")
table = FamilyTableScorer(ds, max_parents=2, base_scorer=scorer)
opt = exact.exact_search(scorer, 5, max_parents=2)
hc = hillclimb.climb_with_restarts(lambda a: hillclimb.hill_climb(table, 5, init_adj=a),
                                   np.random.default_rng(0), restarts=2, max_parents=2)
dh = delta_hill_climb(FamilyBatchScorer(ds, max_parents=2, device="cpu"), 5)
assert abs(hc.best_score - opt.best_score) < 1.0 and abs(dh.best_score - opt.best_score) < 1.0
model = make_model(0, "cpu", num_real_vertices=5, real_label_cardinality=5, embed_size=8,
                   num_heads=2, num_layers=1, latent_size=8, fc_hidden=8, edge_readout=True)
labels = np.stack([np.random.default_rng(i).permutation(5) for i in range(12)]).astype(np.int32)
adj = np.triu(np.random.default_rng(0).random((12, 5, 5)) < 0.3, 1).astype(np.float32)
vectors, targets = build_predictor_dataset(model, scorer, labels, adj, batch_size=8)
keep = np.isfinite(targets)
gp = ExactGP(device="cpu").fit(vectors[keep], targets[keep], iters=10)
SGPR(num_inducing=4, device="cpu").fit(vectors[keep], targets[keep], iters=5)
res = [islands.island_cem_search(model, scorer, num_islands=2, population=8, iters=2,
                                 exploit_repeats=2, device="cpu"),
       latent.refine_search(model, scorer, labels[:2], adj[:2], iters=1, population=16,
                            device="cpu"),
       latent.gp_ascent_search(model, scorer, gp, 0, vectors[:4], steps=3, decode_rounds=1,
                               device="cpu"),
       latent.bo_search(model, scorer, 0, vectors[:4], rounds=1, ascent_steps=2, gp_iters=5,
                        device="cpu")]
assert all(np.isfinite(r.best_score) for r in res), res
print("ok", hc.best_score, [r.best_score for r in res])
"""


def test_port_runs_the_search_stage_without_optional_libraries():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_SEARCH_STAGE_RUN], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


BLOCKED_PIPELINE_RUN = """
import copy, json, os, sys, tempfile
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "pyarrow", "networkx",
             "matplotlib", "dags_vae_search_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import dags_vae_search_tpu_torch.experiments.results as results
import dags_vae_search_tpu_torch.graphs.codec
import dags_vae_search_tpu_torch.utils.profiling
import dags_vae_search_tpu_torch.utils.viz
from dags_vae_search_tpu_torch.experiments import registry, runner
cfg = copy.deepcopy(registry.REGISTRY["asia"])
cfg.corpus.batch_size, cfg.corpus.max_in_degree, cfg.simulate_cases = 1, 3, 300
m = cfg.model
m.embed_size, m.num_heads, m.num_layers, m.latent_size, m.fc_hidden = 8, 2, 1, 16, 8
cfg.train.epochs, cfg.train.batch_size, cfg.train.steps_per_call = 1, 4, 4
s = cfg.search
s.max_parents, s.islands, s.island_population, s.island_iters, s.refine_iters = 3, 2, 8, 1, 1
s.refine_population, s.hill_climb_iters, s.hill_climb_restarts, s.island_subspace = 16, 20, 1, 4
s.budget_compare_evals, s.gp_iters, s.gp_ascent_seeds, s.gp_ascent_rounds, s.bo_rounds = (
    32, 10, 8, 1, 1)
registry.REGISTRY["asia"] = cfg
tmp = tempfile.mkdtemp()
args = ["--data-dir", os.path.join(tmp, "runs"), "--device", "cpu"]
runner.main(["asia", "generate", "split", "train", *args])
try:
    runner.main(["asia", "eval", *args])
    raise SystemExit("eval ran an isomorphism check without networkx")
except ImportError as exc:
    assert "networkx" in str(exc), exc
run = runner.ExperimentRunner(cfg, data_dir=os.path.join(tmp, "runs"), device="cpu")
run.stage_eval(use_isomorphism=False)
runner.main(["asia", "predictor", "gp", "search", *args])
for stage in ("generate", "split", "train", "eval", "predictor", "gp", "search"):
    with open(os.path.join(tmp, "reports_torch", "asia", f"report_{stage}.json")) as fh:
        text = fh.read()
    assert "skipped (" not in text, text
results.main([os.path.join(tmp, "runs"), os.path.join(tmp, "RESULTS_torch.md")])
print("ok", json.loads(text)["hill_climb"]["best_bic"])
"""


def test_port_runs_the_pipeline_cli_without_optional_libraries():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_PIPELINE_RUN], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].startswith("ok")


def test_chip_smoke_refuses_to_run_without_its_package_or_a_card(tmp_path):
    import torch

    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((REPO, REPO / "chip_smoke.py"))
    for cwd, script in runs:
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=300
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
