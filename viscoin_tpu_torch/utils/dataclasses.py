"""``IgnoreNone``: a dataclass base whose fields ignore ``None`` assignments.

Counterpart of ``viscoin_tpu/utils/dataclasses.py``: a ``None`` argument
leaves the field at its default, so optional command-line options pass
straight into the training parameter dataclasses.
"""


class IgnoreNone:
    def __setattr__(self, name, value):
        if value is None:
            return
        super().__setattr__(name, value)
