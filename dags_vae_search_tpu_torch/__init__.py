"""dags_vae_search_tpu_torch — the PyTorch/CUDA port of ``dags_vae_search_tpu``.

The JAX package beside it is the reference: every module here mirrors the
module of the same path there and is held against it by
``tests/test_torch_*.py``.  The port imports neither JAX nor the JAX package.

- ``graphs``      — tensor DAG toolkit, the host-side ER-DAG sampler and the
  corpus codec (npz parts, or parquet through pyarrow).
- ``ops``         — BIC engine: plain torch (``bic_torch``) and the
  contingency-count CUDA kernel (``bic_kernel``, source in ``csrc/``);
  the blocked closure for large DAGs (``reachability``).
- ``scoring``     — datasets, the bnlearn catalog, ``BicScorer``, the
  family table and the family-batch scorer.
- ``models``      — the PACE transformer DAG-VAE and its sampling decode.
- ``training``    — corpus splits, the train loop, checkpoints, eval.
- ``search``      — latent structure search (``decode_and_score``, CEM,
  refine, GP ascent, BO, islands), hill climbing (dense and delta) and
  the exact DP.
- ``surrogate``   — the GP surrogate and its predictor dataset.
- ``utils``       — configs, the tracer (``profiling``: spans and counters on
  the profiler's clock, ``trace`` the operator's Chrome-trace exporter), NaN
  guards, DAG drawing.
- ``experiments`` — the registry, ``ExperimentRunner`` and its CLI
  (``python -m dags_vae_search_tpu_torch.experiments.runner``), the results
  page.
- ``convert``     — loads a flax parameter tree into the port's modules.

Entry points run on ``device="cuda"`` unless the caller names another
device; nothing falls back to the CPU when CUDA is missing.
"""

__version__ = "0.1.0"
