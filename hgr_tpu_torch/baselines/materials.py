"""Baseline materials: word embeddings and classifier-weight extraction
(port of ``hgr_tpu/baselines/materials.py``).

The reference's ``baseline/DGP/materials/`` helpers:

- :class:`GloVe` - GloVe text vectors with the reference's sub-word
  fallback (``materials/glove.py``): a multi-word name averages its words;
  a missing word tries its hyphen parts, then two-way splits, else nothing;
- :func:`wnid_vectors` - per-wnid vectors from class names, zero rows for
  the unknown (``make_induced_graph.py:30-43``, ``pick_vectors``);
- :func:`fc_vectors_from_json` and :func:`fc_vectors_from_torch_resnet` -
  the GCN's regression targets: ``fc-weights.json`` rows, or a torchvision
  ResNet-50's fc rows with the bias as one more column
  (``materials/process_resnet.py``);
- :func:`inject_fc` - a predicted classifier fixed into the standard
  ResNet-50's head (the stage-A' refit, ``train_resnet_fit.py:43-57``);
- :func:`tr_word_vectors`, :func:`logits_with_bias_column` and
  :func:`suppress_seen` - the "Tr" embedding preprocessing, stage B's
  scoring and the DGP scripts' seen-class suppression.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch


class GloVe:
    """Word -> vector store with the reference's fallback lookup."""

    def __init__(self, vectors: Dict[str, np.ndarray], dim: int):
        self.vectors = vectors
        self.dim = dim

    @classmethod
    def from_txt(cls, path: str, dim_hint: int = 300) -> "GloVe":
        vecs: Dict[str, np.ndarray] = {}
        dim = dim_hint
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) < 2:
                    continue
                v = np.asarray(parts[1:], dtype=np.float32)
                dim = len(v)
                vecs[parts[0]] = v
        return cls(vecs, dim)

    def __getitem__(self, word: str) -> Optional[np.ndarray]:
        word = word.lower()
        if word in self.vectors:
            return self.vectors[word]
        if "-" in word:
            got = [self.vectors[p] for p in word.split("-") if p and p in self.vectors]
            if got:
                return np.mean(got, axis=0)
        for i in range(1, len(word)):
            a, b = word[:i], word[i:]
            if a in self.vectors and b in self.vectors:
                return (self.vectors[a] + self.vectors[b]) / 2
        return None

    def name_vector(self, name: str) -> np.ndarray:
        """The mean of a (multi-word) class name's word vectors; zeros when
        nothing resolves (``pick_vectors``)."""
        words = name.replace("_", " ").replace(",", " ").split()
        got = [v for v in (self[w] for w in words) if v is not None]
        if not got:
            return np.zeros(self.dim, np.float32)
        return np.mean(got, axis=0).astype(np.float32)


def wnid_vectors(glove: GloVe, wnids: Sequence[str], names: Dict[str, str]) -> np.ndarray:
    """[len(wnids), dim]; a wnid without a name is looked up as itself."""
    return np.stack([glove.name_vector(names.get(w, w)) for w in wnids])


def _normalize(a: np.ndarray) -> np.ndarray:
    return a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)


def fc_vectors_from_torch_resnet(path: str, normalize: bool = True) -> np.ndarray:
    """[1000, 2049]: a torchvision ResNet-50's ``fc.weight`` rows with
    ``fc.bias`` as the last column (``materials/process_resnet.py``), from a
    ``state_dict`` or a pickled module; the file is trusted, as ``--cnn``
    files are."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    w = sd["fc.weight"].detach().float().numpy()
    b = sd["fc.bias"].detach().float().numpy()[:, None]
    fc = np.concatenate([w, b], axis=1)
    return (_normalize(fc) if normalize else fc).astype(np.float32)


def inject_fc(model, fc_vectors: np.ndarray):
    """Fix [C, D + 1] classifier rows (weights and a bias column) into a
    ``models.resnet_std.ResNet50``'s head as a frozen ``fc``
    (``materials.py:100-113``); features then score against them with a
    ones column (:func:`logits_with_bias_column`). In place; returns the
    model."""
    fc_vectors = np.asarray(fc_vectors, np.float32)
    fc = torch.nn.Linear(fc_vectors.shape[1] - 1, fc_vectors.shape[0])
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(fc_vectors[:, :-1]))
        fc.bias.copy_(torch.from_numpy(fc_vectors[:, -1]))
    model.fc = fc.requires_grad_(False).to(model.conv1.weight.device)
    return model


def fc_vectors_from_json(path: str, normalize: bool = True) -> np.ndarray:
    """The reference's ``fc-weights.json`` (``[[wnid, vector], ...]``,
    ``train_gcn_dense_trans.py:57-68``) -> [N, D] float32."""
    with open(path) as f:
        rows = json.load(f)
    fc = np.asarray([r[1] for r in rows], np.float32)
    return _normalize(fc) if normalize else fc


def tr_word_vectors(feats: np.ndarray) -> np.ndarray:
    """The "Tr" node-embedding preprocessing: ``cat((f, f, ones), 1)``, then
    L2-normalised (``train_gcn_dense_trans.py:70-77``)."""
    f = np.asarray(feats, np.float32)
    return _normalize(np.concatenate([f, f, np.ones((f.shape[0], 1), np.float32)], axis=1))


def logits_with_bias_column(features: torch.Tensor, pred_vectors: torch.Tensor) -> torch.Tensor:
    """Stage B's scoring: [B, D] features with a ones column against
    [N, D + 1] predicted classifiers (``evaluate_imagenet.py:83-89``)."""
    ones = torch.ones((features.shape[0], 1), dtype=features.dtype, device=features.device)
    return torch.cat([features, ones], dim=1) @ pred_vectors.T


def suppress_seen(table: torch.Tensor, seen, value: float = 1e-7) -> torch.Tensor:
    """The DGP ZSL protocol: seen-class columns set to ``value``, not removed
    (``evaluate_21kp.py:93-95``); ``seen`` is a count n (the first n
    columns) or a [N] bool mask. 1e-7 is a reachable logit, kept as the
    JAX package keeps it."""
    if np.ndim(seen) == 0:
        mask = torch.arange(table.shape[1], device=table.device) < int(seen)
    else:
        mask = torch.as_tensor(np.asarray(seen, bool), device=table.device)
    return torch.where(mask[None, :], torch.tensor(value, dtype=table.dtype,
                                                   device=table.device), table)
