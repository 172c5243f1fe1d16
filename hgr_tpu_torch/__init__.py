"""hgr_tpu_torch: the PyTorch and CUDA port of ``hgr_tpu`` for NVIDIA Hopper.

The JAX package ``hgr_tpu`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs. It runs
zero-shot evaluation (the class bank from the CLIP text tower, the RN50 or
ViT image tower, the depth-sorted per-level argmax and the hierarchical
metrics), serving (``serve.ZeroShotClassifier``, ``python -m
hgr_tpu_torch.serve``), OM fine-tuning (``train``, ``driver.run_train``),
its CoOp variant (``models/coop.py``), flat fine-tuning
(``driver.run_train_flat``) and the baselines (``python -m
hgr_tpu_torch.baselines.run``, with their frozen ResNet-50 featurizer and
DGP's backbone refit), on synthetic inputs or on real ones: JSON
hierarchies, BPE prompts (``text``), OpenAI and the port's own
checkpoints, and image files through manifests or a decode cache, decoded
by threads or worker processes (``data``). ``--trace_dir`` writes a
``torch.profiler`` trace of train steps (``utils/profiling.py``). Without gradients, attention on the card is a hand-written
CUDA kernel (``csrc/attention.cu``); the train step runs
the plain attention under autograd, as the JAX step runs XLA's. Entry
points run on CUDA unless the caller passes ``device="cpu"``.

Top-level API::

    from hgr_tpu_torch import Config, Hierarchy, TreeModel
"""

__version__ = "0.1.0"

from .config import Config  # noqa: E402

__all__ = ["Config", "Hierarchy", "TreeModel"]


def __getattr__(name):
    if name == "Hierarchy":
        from .hierarchy import Hierarchy

        return Hierarchy
    if name == "TreeModel":
        from .tree_model import TreeModel

        return TreeModel
    raise AttributeError(name)
