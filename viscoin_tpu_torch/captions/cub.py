"""Compositional captions of CUB's parts, colours, shapes and sizes.

Counterpart of ``viscoin_tpu/captions/cub.py``: a caption is a part with a
colour, a shape and a size where the part has them, the 944 captions of
``cub.txt`` (a copy of the JAX package's, byte for byte), for CLIP
text-embedding experiments.
"""

from __future__ import annotations

import os

parts = [
    "back", "beak", "belly", "breast", "crown", "forehead", "eye", "wings",
    "nape", "leg", "tail", "throat", "eyeline", "eyering", "cap", "crest",
    "eyebrow",
]

colors = [
    "orange", "pink", "black", "purple", "brown", "yellow", "green", "grey",
    "red", "blue", "white", "olive", "iridescent", "buff", "rufous",
    "multi-colored",
]

sizes = ["small", "medium", "large"]

beak_shapes = ["hooked", "needle", "dagger", "cone", "spatulate", "curved"]
tail_shapes = ["forked", "notched", "rounded", "fan-shaped", "pointed", "squared"]
wing_shapes = ["rounded", "tapered", "pointed"]

bonus = {"wings": wing_shapes, "tail": tail_shapes, "beak": beak_shapes}
size_whitelist = ["beak", "wings", "tail"]


def _add_sizes(caption: str, part: str) -> list[str]:
    if part in size_whitelist:
        return [f"{size} {caption}" for size in sizes]
    return [caption]


def generate() -> list[str]:
    """Every caption, in the order of ``cub.txt``."""
    captions: list[str] = []
    for part in parts:
        for color in colors:
            if part in bonus:
                for shape in bonus[part]:
                    captions.extend(_add_sizes(f"{color} {shape} {part}", part))
            else:
                captions.extend(_add_sizes(f"{color} {part}", part))
    return captions


def load() -> list[str]:
    """Load generated captions from disk (cub.txt next to this module)."""
    filepath = os.path.join(os.path.dirname(__file__), "cub.txt")
    with open(filepath) as f:
        return [line.strip() for line in f]


if __name__ == "__main__":
    captions = generate()
    print("Generated", len(captions), "captions")
    filepath = os.path.join(os.path.dirname(__file__), "cub.txt")
    with open(filepath, "w") as f:
        for caption in captions:
            f.write(caption + "\n")
