"""Image preprocessing: the CLIP eval transform on the host, NHWC (the
port's copy of ``hgr_tpu/data/transforms.py``).

Equivalent of the reference's ``_transform`` (canonical at
``clip/clip.py:71-78``, duplicated in all three dataset files): resize the
short side to ``n_px`` with bicubic, center-crop ``n_px``, RGB, as raw
uint8: ``models/clip.encode_image`` normalises with the CLIP mean/std on
the device.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

# torchvision ImageNet statistics — the DGP/CNZSL/FREE baselines' frozen
# ResNet-50 was trained with these (reference
# ``baseline/DGP/train_resnet_fit.py:32-33``), NOT the CLIP constants
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def resized_dims(w: int, h: int, n_px: int):
    """torchvision ``functional.resize(img, n_px)`` output size (w, h).

    Short side becomes ``n_px``; the long side is ``int(n_px * long /
    short)`` — TRUNCATED, not rounded (torchvision 0.8, the reference's
    pin, and current versions alike). If the short side already equals
    ``n_px`` the image is returned unresized (torchvision's short-circuit).
    """
    if (w <= h and w == n_px) or (h <= w and h == n_px):
        return w, h
    if w < h:
        return n_px, max(1, int(n_px * h / w))
    return max(1, int(n_px * w / h)), n_px


def crop_origin(full: int, out: int) -> int:
    """torchvision ``functional.center_crop`` origin along one axis:
    ``int(round((full - out) / 2.0))`` — Python 3 round, i.e. half-to-EVEN
    for odd differences (NOT floor; differs by 1 px when
    ``(full - out) % 4 == 3``)."""
    return int(round((full - out) / 2.0))


def _resize_crop_rgb(img, n_px: int):
    """PIL image -> n_px x n_px RGB PIL image via the torchvision-exact
    Resize(n_px, bicubic) + CenterCrop(n_px) geometry."""
    from PIL import Image

    w, h = img.size
    nw, nh = resized_dims(w, h, n_px)
    if (nw, nh) != (w, h):
        img = img.resize((nw, nh), Image.BICUBIC)
    left = crop_origin(nw, n_px)
    top = crop_origin(nh, n_px)
    img = img.crop((left, top, left + n_px, top + n_px))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def preprocess_pil_uint8(img, n_px: int) -> np.ndarray:
    """PIL image -> [n_px, n_px, 3] uint8 (resize + crop, NO normalization).

    The raw host->device edge: ship uint8 (4x less transfer than float32)
    and let the device normalise (models/clip.py:encode_image)."""
    return np.asarray(_resize_crop_rgb(img, n_px), np.uint8)

