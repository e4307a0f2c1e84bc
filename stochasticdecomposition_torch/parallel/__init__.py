"""Replications over several cards: one process (rank) per card, joined by
``torch.distributed`` (``distributed.py``), laid out as a (rep, obs) mesh
(``mesh.py``), running the replications in waves (``runner.py``)."""
