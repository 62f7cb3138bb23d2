"""Evaluation: the ensemble metrics, concept amplification, the faithfulness
probe (viscoin.py) and the FID statistics (fid.py)."""
