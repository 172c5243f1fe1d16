"""The port's image front end against the JAX package, on the committed
fixtures (``tests/torch_fixtures``): odd sizes, portrait and landscape,
grayscale and CMYK JPEGs, a PNG with alpha, and a corrupt file.

- transforms: the torchvision resize and crop geometry, the constants, and
  the PIL preprocessor's uint8 rows, exactly equal;
- ``FileImageSource``: native rows equal JAX's native rows exactly (the same
  ``decoder.cc`` built with the same flags on this machine), PIL rows equal
  JAX's PIL rows exactly, and a failing file is its class's first image;
- manifests: ``build_index``'s files byte for byte, ``MmapManifest`` and its
  lazy grouped view, ``load_manifest`` and ``kshot_subsample``;
- the decode cache: ``build_cache``'s files byte for byte, from files (by
  threads and by decode processes) and from a ``source=``,
  ``CachedImageSource`` rows, and its refusals.
"""

import filecmp
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hgr_tpu.data import decode_cache as jcache  # noqa: E402
from hgr_tpu.data import manifest_index as jmi  # noqa: E402
from hgr_tpu.data import pipeline as jpipe  # noqa: E402
from hgr_tpu.data import transforms as jtf  # noqa: E402
from hgr_tpu.data.native import load_native as j_load_native  # noqa: E402
from hgr_tpu_torch.data import decode_cache, manifest_index, native, pipeline, transforms  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
IMAGES = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".jpg", ".png"))
GOOD = [n for n in IMAGES if n != "corrupt.jpg"]


def test_transforms_match_jax():
    for name in ("CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD"):
        np.testing.assert_array_equal(getattr(transforms, name), getattr(jtf, name))
    for w in range(1, 80, 3):
        for h in range(1, 80, 7):
            for n_px in (1, 16, 32, 49):
                assert transforms.resized_dims(w, h, n_px) == jtf.resized_dims(w, h, n_px)
        for out in (1, 16, 33):
            assert transforms.crop_origin(w + out, out) == jtf.crop_origin(w + out, out)
    # Python's round is half to even: an odd difference of 3 mod 4 rounds down
    assert transforms.crop_origin(35, 32) == 2 and transforms.crop_origin(33, 32) == 0
    from PIL import Image

    for name in GOOD:
        for n_px in (16, 32, 57):
            img = Image.open(FIXTURES / name)
            np.testing.assert_array_equal(transforms.preprocess_pil_uint8(img, n_px),
                                          jtf.preprocess_pil_uint8(img, n_px))


def test_file_source_rows_match_jax():
    """Every fixture's uint8 rows, at three sizes, with the native decoder
    and without; the corrupt file (and a missing one) comes back as the
    class's first image."""
    assert native.load_native() is not None and j_load_native() is not None, \
        native.native_status()
    for native_on in (True, False):
        _file_rows_match_jax(native_on)


def _file_rows_match_jax(native_on):
    paths = GOOD + ["corrupt.jpg", "missing.jpg"]
    for res in (32, 45, 224):
        ours = pipeline.FileImageSource(res, str(FIXTURES), native=native_on)
        theirs = jpipe.FileImageSource(res, str(FIXTURES), native=native_on)
        assert ours.native == theirs.native == native_on
        for i in range(len(paths)):
            got, want = ours.load("c", paths, i), theirs.load("c", paths, i)
            assert got.dtype == want.dtype == np.uint8 and got.shape == (res, res, 3)
            np.testing.assert_array_equal(got, want, err_msg=f"{paths[i]} {res}")
        np.testing.assert_array_equal(ours.load("c", paths, len(paths) - 2),
                                      ours.load("c", paths, 0))
    if native_on:
        # a JPEG that libjpeg decodes natively differs from PIL's by rounding
        # only; a CMYK one goes to PIL and so is PIL's exactly
        nat = pipeline.FileImageSource(32, str(FIXTURES))
        pil = pipeline.FileImageSource(32, str(FIXTURES), native=False)
        a, b = (s.load("c", ["landscape_97x61.jpg"], 0).astype(int) for s in (nat, pil))
        assert 0 < np.abs(a - b).max() <= 16
        np.testing.assert_array_equal(nat.load("c", ["cmyk_70x50.jpg"], 0),
                                      pil.load("c", ["cmyk_70x50.jpg"], 0))


def _manifest(tmp_path):
    grouped = {f"n{c:03d}": [f"n{c:03d}/{j}_ü.jpg" for j in range(c % 4 + 1)]
               for c in range(9)}
    grouped["n999"] = []
    path = tmp_path / "zsl_test_split.json"
    path.write_text(json.dumps(grouped))
    return grouped, str(path)


def test_manifest_index_matches_jax(tmp_path, capsys):
    grouped, path = _manifest(tmp_path)
    manifest_index.main(["build", path, str(tmp_path / "ours.idx")])
    assert "indexed 10 classes, 21 paths" in capsys.readouterr().out
    jmi.build_index(path, str(tmp_path / "theirs.idx"))
    for f in ("paths.bin", "offsets.npy", "class_ptr.npy", "classes.json"):
        assert filecmp.cmp(tmp_path / "ours.idx" / f, tmp_path / "theirs.idx" / f,
                           shallow=False), f
    ours = manifest_index.MmapManifest(str(tmp_path / "ours.idx"))
    theirs = jmi.MmapManifest(str(tmp_path / "theirs.idx"))
    assert ours.classes == theirs.classes and ours.num_images == theirs.num_images == 21
    for c in grouped:
        assert ours.paths(c) == theirs.paths(c) == grouped[c]
        assert ours.num_paths(c) == len(grouped[c])
    assert ours.path("n003", 2) == theirs.path("n003", 2) == "n003/2_ü.jpg"
    cands = ["n005", "n001", "n999"]
    g, jg = ours.grouped(cands), theirs.grouped(cands)
    assert dict.__getitem__(g, "n001") is None  # decoded on first access only
    assert list(g.items()) == list(jg.items()) == [(c, grouped[c]) for c in cands]
    assert list(ours.grouped().values()) == list(grouped.values())


def test_load_manifest_and_kshot_match_jax(tmp_path):
    grouped, path = _manifest(tmp_path)
    cands = ["n008", "n002", "n004"]
    assert pipeline.load_manifest(path) == jpipe.load_manifest(path) == grouped
    assert pipeline.load_manifest(path, cands) == jpipe.load_manifest(path, cands)
    unseen = ["n003", "n007", "n008", "n999"]
    for k in (1, 2, 5):
        for seed in (0, 1):
            got = pipeline.kshot_subsample(grouped, unseen, k, seed)
            assert got == jpipe.kshot_subsample(grouped, unseen, k, seed)
            assert all(len(got[c]) == min(k, len(grouped[c])) for c in unseen)
            assert all(got[c] == grouped[c] for c in grouped if c not in unseen)


def test_decode_cache_matches_jax(tmp_path):
    grouped = {"a": GOOD[:3] + ["corrupt.jpg"], "b": GOOD[3:], "c": ["portrait_45x130.jpg"]}
    files = ("images.u8", "class_ptr.npy", "offsets.npy", "paths.bin", "meta.json")

    def same(a, b):
        for f in files:
            assert filecmp.cmp(a / f, b / f, shallow=False), f

    decode_cache.build_cache(grouped, str(tmp_path / "ours"), 32, image_root=str(FIXTURES),
                             chunk=2)
    jcache.build_cache(grouped, str(tmp_path / "theirs"), 32, image_root=str(FIXTURES),
                       chunk=2)
    same(tmp_path / "ours", tmp_path / "theirs")
    decode_cache.build_cache(grouped, str(tmp_path / "procs"), 32, image_root=str(FIXTURES),
                             chunk=2, num_procs=2)
    same(tmp_path / "procs", tmp_path / "theirs")
    src = decode_cache.CachedImageSource(str(tmp_path / "ours"), expected_resolution=32)
    online = pipeline.FileImageSource(32, str(FIXTURES))
    for cls, paths in grouped.items():
        for i in range(len(paths)):
            np.testing.assert_array_equal(src.load(cls, paths, i), online.load(cls, paths, i))

    # from a source= (seeded uint8 rows), through open_or_build
    class Rows:
        def load(self, cls, paths, idx):
            return np.random.default_rng([ord(cls), idx]).integers(
                0, 256, (8, 8, 3), dtype=np.uint8)

    big = {"x": [f"x/{j}" for j in range(5)], "y": [f"y/{j}" for j in range(3)]}
    decode_cache.build_cache(big, str(tmp_path / "rows"), 8, source=Rows(), chunk=3)
    jcache.build_cache(big, str(tmp_path / "jrows"), 8, source=Rows(), chunk=3)
    same(tmp_path / "rows", tmp_path / "jrows")
    reopened = decode_cache.open_or_build(str(tmp_path / "rows"), big, 8)
    np.testing.assert_array_equal(reopened.load("y", big["y"], 2), Rows().load("y", big["y"], 2))

    # refusals: a stale path, a missing row, another resolution
    with pytest.raises(ValueError, match="stale"):
        reopened.load("x", ["x/9"] * 5, 1)
    with pytest.raises(KeyError, match="has no row"):
        reopened.load("z", ["z/0"], 0)
    with pytest.raises(ValueError, match="resolution"):
        decode_cache.CachedImageSource(str(tmp_path / "rows"), expected_resolution=16)
