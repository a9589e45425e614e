"""The port's registry finds the reference ``target.csv`` as the JAX one does.

Both packages' ``REFERENCE_DATA`` point at a temporary directory holding a
``bn_<name>/target.csv`` written (with R's unnamed index column) from
``make_synthetic_problem``; then both registries must name it, be equal
field by field, and both runners must score against the same codes and
cards (exact).  Loading the CSV needs pandas, as in the JAX package.
"""

import dataclasses

import numpy as np
import pytest

from dags_vae_search_tpu.experiments import registry as jregistry
from dags_vae_search_tpu.experiments import runner as jrunner
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu_torch.experiments import registry as tregistry
from dags_vae_search_tpu_torch.experiments import runner as trunner


def _write_target_csv(root, name, max_card):
    pd = pytest.importorskip("pandas")
    _, ds = jcatalog.make_synthetic_problem(name, num_cases=300, max_card=max_card, seed=7)
    path = root / f"bn_{name}" / "target.csv"
    path.parent.mkdir(parents=True)
    levels = np.asarray(ds.codes).astype(str).astype(object)
    frame = pd.DataFrame({f"V{i}": "s" + levels[:, i] for i in range(levels.shape[1])})
    frame.to_csv(path)  # the first column is the unnamed row index, as R writes it
    return str(path)


@pytest.mark.parametrize("name,max_card", [("asia", 2), ("alarm", 4)])
def test_both_registries_and_runners_load_the_reference_csv(tmp_path, monkeypatch, name, max_card):
    csv = _write_target_csv(tmp_path / "reference", name, max_card)
    monkeypatch.setattr(jregistry, "REFERENCE_DATA", str(tmp_path / "reference"))
    monkeypatch.setattr(tregistry, "REFERENCE_DATA", str(tmp_path / "reference"))
    jcfg, tcfg = jregistry.build_registry()[name], tregistry.build_registry()[name]
    assert tcfg.dataset_csv == jcfg.dataset_csv == csv
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # an experiment without a CSV there simulates in both
    assert tregistry.build_registry()["sachs"].dataset_csv is None

    jds = jrunner.ExperimentRunner(jcfg, data_dir=str(tmp_path / "jax")).scoring_dataset()
    tds = trunner.ExperimentRunner(tcfg, data_dir=str(tmp_path / "torch"),
                                   device="cpu").scoring_dataset()
    np.testing.assert_array_equal(tds.codes, np.asarray(jds.codes))
    np.testing.assert_array_equal(tds.cards, np.asarray(jds.cards))
    assert list(tds.columns) == list(jds.columns)
    assert tds.num_cases == 300 and int(tds.cards.max()) <= max_card


def test_without_the_reference_data_both_registries_simulate(tmp_path, monkeypatch):
    monkeypatch.setattr(jregistry, "REFERENCE_DATA", str(tmp_path / "missing"))
    monkeypatch.setattr(tregistry, "REFERENCE_DATA", str(tmp_path / "missing"))
    jreg, treg = jregistry.build_registry(), tregistry.build_registry()
    assert sorted(treg) == sorted(jreg)
    for name in treg:
        assert treg[name].dataset_csv is None
        assert dataclasses.asdict(treg[name]) == dataclasses.asdict(jreg[name]), name
