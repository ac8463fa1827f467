"""IEMOCAP data for stage B: the dataset, the bucketed loader and the
synthetic fixture writer (numpy only)."""

from .datasets import Dialogue, IEMOCAPDataset
from .loaders import DEFAULT_BUCKETS, Batch, BucketedLoader, collate, get_iemocap_loaders
from .synthetic import IEMOCAP_DIMS, write_synthetic_iemocap

__all__ = [
    "Batch",
    "BucketedLoader",
    "DEFAULT_BUCKETS",
    "Dialogue",
    "IEMOCAPDataset",
    "IEMOCAP_DIMS",
    "collate",
    "get_iemocap_loaders",
    "write_synthetic_iemocap",
]
