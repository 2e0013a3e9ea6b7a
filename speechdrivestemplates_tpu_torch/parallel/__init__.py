"""Data parallelism over ranks (``dist.py``) and the sequence-parallel demo
forward (``seqparallel.py``), the JAX package's ``parallel/``. Only ``dist``
is imported here: the model blocks import it, and ``seqparallel`` imports
the model blocks."""

from . import dist  # noqa: F401
