"""Write the small image fixtures of the port's file tests and of
``chip_smoke.py`` (the card's machine needs no image encoder):

    python tests/torch_fixtures/make_fixtures.py

Odd sizes in landscape and portrait, a grayscale and a CMYK JPEG (libjpeg
cannot hand CMYK to the native decoder as RGB, so it falls back to PIL), a
PNG with alpha, and a file that is no image at all. Seeded, so a rerun
writes the same pixels.
"""

from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def _pattern(w, h, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(w, h)
    base = np.stack([np.sin(7 * x + 3 * y), np.cos(5 * y - 2 * x), x * y], -1)
    noise = rng.standard_normal((h // 8 + 1, w // 8 + 1, 3))
    noise = np.kron(noise, np.ones((8, 8, 1)))[:h, :w]
    img = base + 0.3 * noise
    return ((img - img.min()) / np.ptp(img) * 255).astype(np.uint8)


def main():
    Image.fromarray(_pattern(97, 61, 0)).save(HERE / "landscape_97x61.jpg", quality=90)
    Image.fromarray(_pattern(45, 130, 1)).save(HERE / "portrait_45x130.jpg", quality=90)
    Image.fromarray(_pattern(83, 83, 2)).convert("L").save(HERE / "gray_83x83.jpg", quality=90)
    Image.fromarray(_pattern(70, 50, 3)).convert("CMYK").save(HERE / "cmyk_70x50.jpg",
                                                               quality=90)
    rgba = np.concatenate([_pattern(33, 47, 4), np.full((47, 33, 1), 200, np.uint8)], -1)
    Image.fromarray(rgba).save(HERE / "alpha_33x47.png")
    (HERE / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0 this is not a jpeg")


if __name__ == "__main__":
    main()
