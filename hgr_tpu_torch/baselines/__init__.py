"""The baselines of the paper's tables (port of ``hgr_tpu/baselines``):
CLIP-flat fine-tuning, CNZSL, the DGP/SGCN graph networks and FREE, each
trained and then evaluated with the shared hierarchical metrics by
``python -m hgr_tpu_torch.baselines.run``. Their weights are nested dicts of
tensors, as the JAX package's are of arrays; random draws are arguments or
come from a ``torch.Generator``. Real images reach them through the frozen
standard ResNet-50 (``features.py`` over ``models/resnet_std.py``), which
DGP's stage A' refits under the predicted classifiers (``refit.py``)."""

from .clip_flat import make_flat_loss_fn, make_flat_train_step, step_lr
from .cnzsl import CNZSLConfig, cnzsl_init, cnzsl_logits, make_cnzsl_train_step
from .free import FREEConfig, free_init, make_free_steps, synthesize_features, train_softmax_classifier
from .gcn import (
    Adjacency,
    GCNConfig,
    basic_edges,
    dense_edges,
    gcn_apply,
    gcn_init,
    make_gcn_train_step,
    masked_l2_loss,
)

__all__ = [
    "make_flat_loss_fn",
    "make_flat_train_step",
    "step_lr",
    "CNZSLConfig",
    "cnzsl_init",
    "cnzsl_logits",
    "make_cnzsl_train_step",
    "FREEConfig",
    "free_init",
    "make_free_steps",
    "synthesize_features",
    "train_softmax_classifier",
    "Adjacency",
    "GCNConfig",
    "basic_edges",
    "dense_edges",
    "gcn_apply",
    "gcn_init",
    "make_gcn_train_step",
    "masked_l2_loss",
]
