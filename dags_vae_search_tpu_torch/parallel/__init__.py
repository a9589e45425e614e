"""Data parallelism on ``torch.distributed``: the mesh (``mesh.py``) and the
multi-process dry run (``dryrun.py``)."""
