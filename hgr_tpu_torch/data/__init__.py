from .pipeline import (
    FileImageSource,
    FlatTrainLoader,
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
    "FlatTrainLoader",
    "GroupBatch",
    "GroupedTestLoader",
    "GroupedTrainLoader",
    "ImageSource",
    "Prefetcher",
    "SyntheticImageSource",
    "kshot_subsample",
    "load_manifest",
]
