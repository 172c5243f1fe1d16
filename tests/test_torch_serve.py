"""The port's serving API against ``hgr_tpu.serve``, on the CPU in fp32.

``ZeroShotClassifier`` on TEST-ViT with the JAX weights: ``classify`` gives
the same node ids and scores within 1e-5 for every candidate set, ranking
tied scores lower depth-sorted column first as ``lax.top_k`` does (the test
makes ties by giving classes the same bank row), and ``predict_paths`` the
same per-level ids. Decode processes (``num_procs > 0``) raise
``NotYetPorted``; files and the CLI are held to JAX in
``tests/test_torch_realdata.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgr_tpu.config import Config as JConfig  # noqa: E402
from hgr_tpu.hierarchy import synthetic_hierarchy as j_synthetic  # noqa: E402
from hgr_tpu.serve import ZeroShotClassifier as JClassifier  # noqa: E402
from hgr_tpu.tree_model import TreeModel as JTreeModel  # noqa: E402
from hgr_tpu_torch import serve  # noqa: E402
from hgr_tpu_torch.config import Config  # noqa: E402
from hgr_tpu_torch.driver import NotYetPorted, synthetic_splits  # noqa: E402
from hgr_tpu_torch.hierarchy import synthetic_hierarchy  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402
from hgr_tpu_torch.tree_model import TreeModel  # noqa: E402


@pytest.fixture(scope="module")
def models():
    hier, jhier = synthetic_hierarchy(3, 4, 5, 0), j_synthetic(3, 4, 5, 0)
    splits = synthetic_splits(hier, 0)
    jtm = JTreeModel.build(JConfig(arch="TEST-ViT", dtype="float32"), jhier,
                           splits["all"], splits["rest"], pad_multiple=64)
    jtm.init_params(0)
    tm = TreeModel.build(Config(arch="TEST-ViT", dtype="float32"), hier, splits["all"],
                         splits["rest"], pad_multiple=64, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtm.params), tm.clip_cfg))
    images = np.random.default_rng(0).standard_normal((6, 32, 32, 3)).astype(np.float32)
    return jtm, tm, images


def _tied(clf, jclf, images, n_tied=12):
    """Both banks with ``n_tied`` candidate classes given the row of the
    first image's best class, so that their scores tie exactly with it, at
    the top of that image's ranking."""
    clf.refresh_bank()
    jclf.refresh_bank()
    bank = np.asarray(jclf.bank_sorted).copy()
    np.testing.assert_allclose(clf.bank_sorted.numpy(), bank, rtol=1e-5, atol=1e-6)
    best = int(jclf.classify(images[:1], k=1)[0][0, 0])
    order = np.asarray(clf.tm.depth_order)
    rows = np.flatnonzero(clf._mask_sorted.numpy())[:n_tied]
    bank[rows] = bank[int(np.flatnonzero(order == best)[0])]
    jclf.bank_sorted = jnp.asarray(bank)
    clf.bank_sorted = torch.from_numpy(bank)


def test_classify_matches_jax(models):
    jtm, tm, images = models
    for candidates in ("all", "test", "train"):
        clf = serve.ZeroShotClassifier(tm, candidates=candidates)
        jclf = JClassifier(jtm, candidates=candidates)
        _tied(clf, jclf, images)
        for k in (1, 5, 20):
            ids, vals = clf.classify(images, k=k)
            want_ids, want_vals = jclf.classify(images, k=k)
            assert ids.dtype == want_ids.dtype and ids.shape == (len(images), k)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-5)
        # the first image ranks the tied classes first, in the same order
        assert (vals[0, :12] == vals[0, 0]).all()


def test_predict_paths_matches_jax(models):
    jtm, tm, images = models
    clf = serve.ZeroShotClassifier(tm)
    got = clf.predict_paths(images)
    want = JClassifier(jtm).predict_paths(images)
    assert got.shape == want.shape == (len(images), tm.hier.max_depth + 1)
    np.testing.assert_array_equal(got, want)
    assert (tm.hier.depth[got] == np.arange(got.shape[1])[None, :]).all()


def test_file_paths_not_yet_ported(models):
    """The file paths are ported but their decode processes are not: both
    refuse ``num_procs > 0`` before decoding anything."""
    _, tm, _ = models
    with pytest.raises(NotYetPorted, match="decode processes"):
        serve.ZeroShotClassifier(tm).classify_files(["a.jpg"], num_procs=2)
    with pytest.raises(NotYetPorted, match="decode processes"):
        serve.main(["a.jpg", "--synthetic", "True", "--arch", "TEST-ViT",
                    "--num_procs", "2"], device="cpu")
