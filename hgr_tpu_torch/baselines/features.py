"""Real-image features for the baselines' stage-B evaluation and training
(port of ``hgr_tpu/baselines/features.py``).

The reference's DGP, CNZSL and FREE evaluation featurizes every eval batch
through the frozen ResNet-50 (``feat = cnn(data)``,
``baseline/DGP/evaluate_imagenet.py:84``, in fp16 at ``:201``) after the
torchvision eval transform Resize(256) + CenterCrop(224) + ImageNet
normalisation (``train_resnet_fit.py:32-41``).

- :func:`load_backbone` - the frozen ResNet-50 (``models/resnet_std``) from
  a torchvision checkpoint or from the port's own ``save_pytree`` artifact;
- :func:`preprocess_for_backbone` - the centre crop with torchvision's
  half-to-even origin and the ImageNet normalisation, on the device;
- :func:`make_featurizer` - uint8 ``[B, R, R, 3]`` -> ``[B, 2048]`` fp32,
  bf16 on the card as the JAX featurizer runs on the TPU;
- :func:`export_image_features` - a manifest featurized once into a
  :class:`FeatureFile`;
- :class:`FeatureFile` - per-class feature rows (an ``.npz`` keyed by wnid),
  row i aligned with the class's manifest path i; also the CNZSL/FREE
  training features of the reference's regime (``train_free.py:246-247``);
- :func:`with_bias_column` - the DGP ones column when the classifiers are
  one wider than the features.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def load_backbone(path: str, device=None):
    """The frozen ResNet-50 of ``path`` on ``device`` (default the CPU), in
    eval use:

    - ``*.pt`` / ``*.pth``: a torchvision checkpoint, a ``state_dict`` or a
      pickled module (the reference's ``--cnn``, ``evaluate_imagenet.py:
      198-202``; the file is trusted);
    - a directory written by ``utils/checkpoint.save_pytree``: a
      ``state_dict``, or a tree whose ``params`` is one (the runner's
      ``{save_path}_refit``).

    A directory of the JAX package (an Orbax pytree) is refused: its reader
    is ROADMAP Queue 1 item 6.
    """
    from ..models.resnet_std import convert_torch_resnet
    from ..utils.checkpoint import STATE_FILE, load_pytree

    if path.endswith((".pt", ".pth")):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    elif os.path.exists(os.path.join(path, STATE_FILE)):
        sd = load_pytree(path)
        sd = sd.get("params", sd)
    else:
        raise ValueError(
            f"--cnn {path}: neither a torch .pt/.pth checkpoint nor a save_pytree directory "
            f"(no {STATE_FILE}); reading the JAX package's Orbax checkpoints is ROADMAP "
            "Queue 1 item 6, not yet ported")
    return convert_torch_resnet(sd).to(device)


def preprocess_for_backbone(images: torch.Tensor, crop: int) -> torch.Tensor:
    """``[B, R, R, 3]`` uint8 (or [0, 1] float) -> the ImageNet-normalised
    fp32 centre crop of size ``crop``. With the loader's short-side resize
    and centre crop to R = 256, ``crop=224`` takes the pixels of
    torchvision's Resize(256) + CenterCrop(224) (``train_resnet_fit.py:
    32-41``); the origin is torchvision's half-to-even one, which differs
    from floor by a pixel when (R - crop) % 4 == 3."""
    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, crop_origin

    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    r = x.shape[1]
    if crop < r:
        off = crop_origin(r, crop)
        x = x[:, off: off + crop, off: off + crop, :]
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def make_featurizer(model, crop: int = 224, dtype=None):
    """``[B, R, R, 3]`` uint8 images (numpy or a tensor) -> ``[B, 2048]``
    fp32 features on the model's device, eval-mode BatchNorm, no gradient.
    ``crop < R`` is torchvision's Resize(256) + CenterCrop(224) over the
    loader's 256 px rows (:func:`preprocess_for_backbone`). ``dtype``
    defaults to bf16 on the card (the reference runs this stage in fp16)
    and fp32 on the CPU, the route the tests hold to the JAX package."""
    from ..models.resnet_std import resnet50_features

    dev = next(model.parameters()).device
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    @torch.inference_mode()
    def feats(images) -> torch.Tensor:
        x = preprocess_for_backbone(torch.as_tensor(images, device=dev), crop)
        return resnet50_features(model, x, dtype=dtype).float()

    return feats


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


def export_image_features(
    grouped: Dict[str, list],
    image_root: str,
    model,
    out_path: str,
    resolution: int = 256,
    crop: int = 224,
    batch: int = 64,
    num_threads: int = 8,
    num_procs: int = 0,
) -> str:
    """Featurize every image of ``grouped`` once into an ``.npz``
    :class:`FeatureFile` (``features.py:138-178``): a corpus read more than
    once (CNZSL/FREE training, repeated evaluations) pays the CNN once.
    ``num_procs > 0`` decodes in that many processes."""
    from ..data.pipeline import FileImageSource, GroupedTestLoader

    feats_fn = make_featurizer(model, crop=crop)
    loader = GroupedTestLoader(grouped, {c: i for i, c in enumerate(grouped)},
                               FileImageSource(resolution, image_root=image_root), batch,
                               num_threads=num_threads, num_procs=num_procs)
    names = list(grouped)
    out: Dict[str, list] = {c: [] for c in names}
    try:
        for b in loader:
            out[names[b.target]].append(feats_fn(b.images).cpu().numpy()[b.valid])
    finally:
        loader.close()
    np.savez(out_path, **{c: np.concatenate(v, axis=0) for c, v in out.items() if v})
    return out_path
