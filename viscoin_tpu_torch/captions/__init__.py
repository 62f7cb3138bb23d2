"""Generated captions (``captions/cub.py``)."""
