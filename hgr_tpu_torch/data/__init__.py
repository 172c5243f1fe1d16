from .pipeline import (
    FileImageSource,
    GroupBatch,
    GroupedTestLoader,
    GroupedTrainLoader,
    ImageSource,
    Prefetcher,
    SyntheticImageSource,
    kshot_subsample,
    load_manifest,
)

__all__ = [
    "FileImageSource",
    "GroupBatch",
    "GroupedTestLoader",
    "GroupedTrainLoader",
    "ImageSource",
    "Prefetcher",
    "SyntheticImageSource",
    "kshot_subsample",
    "load_manifest",
]
