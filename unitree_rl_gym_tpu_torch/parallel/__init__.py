"""Env-batch data parallelism over ``torch.distributed`` ranks
(``parallel/mesh.py``) and its multi-rank dryrun (``parallel/dryrun.py``)."""
