from .pipeline import (
    GroupBatch,
    GroupedTestLoader,
    GroupedTrainLoader,
    Prefetcher,
    SyntheticImageSource,
)

__all__ = [
    "GroupBatch",
    "GroupedTestLoader",
    "GroupedTrainLoader",
    "Prefetcher",
    "SyntheticImageSource",
]
