"""Data and tensor parallelism over torch.distributed (``parallel/mesh.py``,
``parallel/tp.py``; ``parallel/dryrun.py``, the dp and dp x tp dry run)."""
