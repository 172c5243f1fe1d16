"""DGP stage-A' backbone refit: retrain the ResNet-50 base under a frozen
GCN-predicted classifier (port of ``hgr_tpu/baselines/refit.py``).

The reference's ``baseline/DGP/train_resnet_fit.py``: the predicted fc rows
of the seen classes are fixed into the head (``:50-52``: weight =
pred[:, :-1], bias = pred[:, -1]) and only the base trains (``:57``), with
SGD (lr 1e-4, momentum 0.9; ``torch.optim.SGD`` steps as ``optax.sgd``
does), cross-entropy over the seen classes (``:58,74-75``) and train-mode
BatchNorm (``:55``), whose running statistics are written after the update.
The running loss and accuracy follow the reference's EMA with keep ratio
0.9975 (``:60,83-85``) into a ``trlog`` history (``:61-63,94-95``).

Augmentation: the reference's RandomHorizontalFlip is a per-row boolean
argument of the step (the tests hand in the JAX package's draws;
``refit_backbone`` draws them from a ``torch.Generator``); its
RandomResizedCrop is not replicated, the loader's deterministic resize and
centre crop stand in, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def fc_from_pred(pred_vectors: np.ndarray, feat_dim: int = 2048) -> Dict[str, np.ndarray]:
    """Predicted classifier rows -> the frozen head ``{"w": [D, C], "b":
    [C]}``: [C, D + 1] rows are weights and a bias column
    (``train_resnet_fit.py:50-52``), [C, D] rows get a zero bias."""
    pred_vectors = np.asarray(pred_vectors, np.float32)
    if pred_vectors.shape[1] == feat_dim + 1:
        return {"w": pred_vectors[:, :-1].T.copy(), "b": pred_vectors[:, -1].copy()}
    if pred_vectors.shape[1] == feat_dim:
        return {"w": pred_vectors.T.copy(), "b": np.zeros(pred_vectors.shape[0], np.float32)}
    raise ValueError(
        f"pred rows are {pred_vectors.shape[1]}-d; expected feat_dim ({feat_dim}) or "
        "feat_dim+1 (weights + bias column)")


def make_refit_step(opt: torch.optim.Optimizer, crop: int, dtype=None):
    """-> ``step(model, images, labels, valid, flip)``: one update of
    ``opt`` (over the base's parameters) under the model's frozen fc head,
    BatchNorm in train mode and its running statistics written after the
    update; returns ``(loss, acc)`` as 0-d tensors. ``images`` is uint8
    ``[B, R, R, 3]`` on the model's device, ``flip`` a [B] bool tensor (the
    rows to mirror). ``dtype`` defaults to bf16 on the card, fp32 on the
    CPU."""
    from ..models.resnet_std import apply_bn_stats, resnet50_features_train
    from .features import preprocess_for_backbone

    def step(model, images, labels, valid, flip):
        if dtype is None:
            cdt = torch.bfloat16 if images.device.type == "cuda" else torch.float32
        else:
            cdt = dtype
        images = torch.where(flip[:, None, None, None], images.flip(2), images)
        x = preprocess_for_backbone(images, crop)
        feats, stats = resnet50_features_train(model, x, dtype=cdt)
        logits = F.linear(feats.float(), model.fc.weight, model.fc.bias)
        ce = -torch.log_softmax(logits, dim=1).gather(1, labels[:, None])[:, 0]
        denom = valid.sum().clamp_min(1)
        loss = torch.where(valid, ce, 0.0).sum() / denom
        hit = (logits.argmax(dim=1) == labels) & valid
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        apply_bn_stats(model, stats)
        return loss.detach(), hit.sum() / denom

    return step


def draw_flips(g: torch.Generator, n: int, device) -> torch.Tensor:
    """One step's flips: each row mirrored with probability 1/2."""
    return (torch.rand(n, generator=g) < 0.5).to(device)


def refit_backbone(model, pred_vectors: np.ndarray, loader, steps: int, lr: float = 1e-4,
                   crop: int = 224, seed: int = 0, log_every: int = 0) -> Tuple[object, Dict]:
    """The stage-A' loop -> ``(model, trlog)``, the model refit in place
    with the frozen head of ``pred_vectors`` as its fc (so that it goes
    straight into ``features.make_featurizer`` or ``resnet50_logits``).
    ``loader`` is a ``FlatTrainLoader`` over the seen-class images whose
    labels index rows of ``pred_vectors`` (``train_resnet_fit.py:43``);
    epochs cycle until ``steps`` batches have been taken."""
    from .materials import inject_fc

    dev = next(model.parameters()).device
    fc = fc_from_pred(pred_vectors, feat_dim=model.conv1.weight.shape[0] * 32)
    inject_fc(model, np.concatenate([fc["w"].T, fc["b"][:, None]], axis=1))
    opt = torch.optim.SGD(model.base_parameters(), lr=lr, momentum=0.9)
    step = make_refit_step(opt, crop)
    g = torch.Generator().manual_seed(seed)

    keep = 0.9975  # the reference's running-average keep ratio (:60)
    ave_loss = ave_acc = None
    trlog = {"loss": [], "acc": [], "step_loss": []}
    done, epoch = 0, 0
    while done < steps:
        loader.set_epoch(epoch)
        for images, labels, valid in loader:
            t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
            loss, acc = step(model, t(images), t(labels).long(), t(valid),
                             draw_flips(g, len(labels), dev))
            loss, acc = float(loss), float(acc)
            trlog["step_loss"].append(loss)
            if ave_loss is None:
                ave_loss, ave_acc = loss, acc
            else:
                ave_loss = ave_loss * keep + loss * (1 - keep)
                ave_acc = ave_acc * keep + acc * (1 - keep)
            done += 1
            if log_every and done % log_every == 0:
                print(f"refit {done}/{steps}: loss={loss:.4f} ({ave_loss:.4f}), "
                      f"acc={acc:.4f} ({ave_acc:.4f})", flush=True)
            if done >= steps:
                break
        trlog["loss"].append(ave_loss)
        trlog["acc"].append(ave_acc)
        epoch += 1
    return model, trlog
