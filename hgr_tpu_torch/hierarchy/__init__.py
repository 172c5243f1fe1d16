from .tree import PAD, ROOT, Hierarchy, profiled_edges, profiled_hierarchy, synthetic_hierarchy

__all__ = ["Hierarchy", "profiled_edges", "profiled_hierarchy", "synthetic_hierarchy", "ROOT",
           "PAD"]
