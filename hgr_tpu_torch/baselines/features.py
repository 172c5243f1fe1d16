"""Precomputed features for the baselines' stage-B evaluation and training
(port of ``hgr_tpu/baselines/features.py:107-137``).

- :class:`FeatureFile` - per-class feature rows (an ``.npz`` keyed by
  wnid), row i aligned with the class's manifest path i: features computed
  once ahead of time, and the CNZSL/FREE training features of the
  reference's regime (``train_free.py:246-247``);
- :func:`with_bias_column` - the DGP ones column when the classifiers are
  one wider than the features.

The frozen ResNet-50 featurizer (``load_backbone``, ``make_featurizer``,
``export_image_features``) waits for the port of ``models/resnet_std.py``
and raises :class:`NotYetPorted`.
"""

from __future__ import annotations

import numpy as np

from ..config import NotYetPorted


class FeatureFile:
    """An ``.npz`` of wnid -> [n_i, D] float rows."""

    def __init__(self, path: str):
        self._z = np.load(path)
        self.dim = int(self._z[self._z.files[0]].shape[1])

    def rows(self, wnid: str) -> np.ndarray:
        if wnid not in self._z:
            raise KeyError(f"feature file has no class {wnid!r}")
        return np.asarray(self._z[wnid], np.float32)

    def take(self, wnid: str, idxs) -> np.ndarray:
        return self.rows(wnid)[np.asarray(idxs, np.int64)]


def with_bias_column(feats: np.ndarray, proto_dim: int) -> np.ndarray:
    """Append the ones column when the classifier space is one wider than
    the features (``evaluate_imagenet.py:85``)."""
    feats = np.asarray(feats, np.float32)
    if proto_dim == feats.shape[1] + 1:
        return np.concatenate([feats, np.ones((feats.shape[0], 1), np.float32)], axis=1)
    return feats


def _featurizer_not_ported(*args, **kwargs):
    raise NotYetPorted("the frozen ResNet-50 featurizer (--cnn) waits for the port of "
                       "hgr_tpu/models/resnet_std.py and baselines/features.py:32-106")


load_backbone = make_featurizer = export_image_features = _featurizer_not_ported
