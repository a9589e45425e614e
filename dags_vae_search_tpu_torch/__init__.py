"""dags_vae_search_tpu_torch — the PyTorch/CUDA port of ``dags_vae_search_tpu``.

The JAX package beside it is the reference: every module here mirrors the
module of the same path there and is held against it by
``tests/test_torch_*.py``.  The port imports neither JAX nor the JAX package.

- ``graphs``      — tensor DAG toolkit and the host-side ER-DAG sampler.
- ``ops``         — BIC engine: plain torch (``bic_torch``) and the
  contingency-count CUDA kernel (``bic_kernel``, source in ``csrc/``).
- ``scoring``     — datasets, the bnlearn catalog, ``BicScorer``.
- ``models``      — the PACE transformer DAG-VAE and its sampling decode.
- ``search``      — latent structure search (``decode_and_score``, CEM).
- ``utils``, ``experiments`` — configs and the experiment registry.
- ``convert``     — loads a flax parameter tree into the port's modules.

Entry points run on ``device="cuda"`` unless the caller names another
device; nothing falls back to the CPU when CUDA is missing.
"""

__version__ = "0.1.0"
