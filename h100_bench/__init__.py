"""The benchmark of ``dags_vae_search_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell once; ``harness.py`` drives it from the files named
in ``BENCHMARK.json``: configurations (``configs/``), cells
(``workloads/``), traffic generators (``traffic/``), per-layer metrics
(``metrics/``), the plain reference (``reference/``) and the peaks
(``peaks.py``).  ``control.py`` reads the controls of the checks.
"""
