"""Data parallelism: one process per card, explicit collectives (mesh.py)."""
