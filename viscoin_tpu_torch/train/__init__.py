"""Training: the VisCoIN step (viscoin.py) and its losses (losses.py)."""
