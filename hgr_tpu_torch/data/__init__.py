from .pipeline import (
    GroupBatch,
    GroupedTestLoader,
    Prefetcher,
    SyntheticImageSource,
)

__all__ = [
    "GroupBatch",
    "GroupedTestLoader",
    "Prefetcher",
    "SyntheticImageSource",
]
