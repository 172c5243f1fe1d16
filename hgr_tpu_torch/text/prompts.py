"""Prompt template banks (the port's copy of ``hgr_tpu/text/prompts.py``,
verbatim).

The contents are OpenAI CLIP's public ImageNet prompt-ensemble strings (the
same data the reference vendors at ``data/templates.py:1-100``); the 80-prompt
standard bank, the 7-prompt selected subset, the empty template, and the simple
single template the tree model hard-codes (reference ``model/clip_tree.py:52``).

Stored as newline blocks and parsed at import; each bank is an immutable tuple.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _bank(block: str) -> Tuple[str, ...]:
    return tuple(line for line in block.strip("\n").split("\n") if line)


TEMPLATES_STANDARD: Tuple[str, ...] = _bank("""
a bad photo of a {}.
a photo of many {}.
a sculpture of a {}.
a photo of the hard to see {}.
a low resolution photo of the {}.
a rendering of a {}.
graffiti of a {}.
a bad photo of the {}.
a cropped photo of the {}.
a tattoo of a {}.
the embroidered {}.
a photo of a hard to see {}.
a bright photo of a {}.
a photo of a clean {}.
a photo of a dirty {}.
a dark photo of the {}.
a drawing of a {}.
a photo of my {}.
the plastic {}.
a photo of the cool {}.
a close-up photo of a {}.
a black and white photo of the {}.
a painting of the {}.
a painting of a {}.
a pixelated photo of the {}.
a sculpture of the {}.
a bright photo of the {}.
a cropped photo of a {}.
a plastic {}.
a photo of the dirty {}.
a jpeg corrupted photo of a {}.
a blurry photo of the {}.
a photo of the {}.
a good photo of the {}.
a rendering of the {}.
a {} in a video game.
a photo of one {}.
a doodle of a {}.
a close-up photo of the {}.
a photo of a {}.
the origami {}.
the {} in a video game.
a sketch of a {}.
a doodle of the {}.
a origami {}.
a low resolution photo of a {}.
the toy {}.
a rendition of the {}.
a photo of the clean {}.
a photo of a large {}.
a rendition of a {}.
a photo of a nice {}.
a photo of a weird {}.
a blurry photo of a {}.
a cartoon {}.
art of a {}.
a sketch of the {}.
a embroidered {}.
a pixelated photo of a {}.
itap of the {}.
a jpeg corrupted photo of the {}.
a good photo of a {}.
a plushie {}.
a photo of the nice {}.
a photo of the small {}.
a photo of the weird {}.
the cartoon {}.
art of the {}.
a drawing of the {}.
a photo of the large {}.
a black and white photo of a {}.
the plushie {}.
a dark photo of a {}.
itap of a {}.
graffiti of the {}.
a toy {}.
itap of my {}.
a photo of a cool {}.
a photo of a small {}.
a tattoo of the {}.
""")

TEMPLATES_SELECT: Tuple[str, ...] = _bank("""
itap of a {}.
a bad photo of the {}.
a origami {}.
a photo of the large {}.
a {} in a video game.
art of the {}.
a photo of the small {}.
""")

TEMPLATES_EMPTY: Tuple[str, ...] = ("{}",)

TEMPLATES_SIMPLE: Tuple[str, ...] = ("a photo of a {}.",)

BANKS: Dict[str, Tuple[str, ...]] = {
    "TEMPLATES_STANDARD": TEMPLATES_STANDARD,
    "TEMPLATES_SELECT": TEMPLATES_SELECT,
    "TEMPLATES_EMPTY": TEMPLATES_EMPTY,
    "TEMPLATES_SIMPLE": TEMPLATES_SIMPLE,
}


def get_bank(name: str) -> Tuple[str, ...]:
    """Look up a template bank by its reference name (``--template`` flag)."""
    try:
        return BANKS[name]
    except KeyError:
        raise KeyError(f"unknown template bank {name!r}; options: {sorted(BANKS)}")
