"""hgr_tpu_torch: the PyTorch and CUDA port of ``hgr_tpu`` for NVIDIA Hopper.

The JAX package ``hgr_tpu`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs. It runs
the zero-shot evaluation path: class bank from the CLIP text tower (whose
attention is a hand-written CUDA kernel on the card, ``csrc/attention.cu``),
the RN50 image tower, the depth-sorted per-level argmax and the
hierarchical metrics. Entry points run on CUDA unless the caller passes
``device="cpu"``.

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
