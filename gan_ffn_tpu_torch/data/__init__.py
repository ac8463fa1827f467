"""The IEMOCAP data of stage B and the MELD data of the MELD entry point:
the datasets, the bucketed loaders and the synthetic fixture writers (numpy
only)."""

from .datasets import Dialogue, IEMOCAPDataset, MELDDataset
from .loaders import (DEFAULT_BUCKETS, Batch, BucketedLoader, collate, get_iemocap_loaders,
                      get_meld_loaders)
from .synthetic import IEMOCAP_DIMS, MELD_DIMS, write_synthetic_iemocap, write_synthetic_meld

__all__ = [
    "Batch",
    "BucketedLoader",
    "DEFAULT_BUCKETS",
    "Dialogue",
    "IEMOCAPDataset",
    "IEMOCAP_DIMS",
    "MELDDataset",
    "MELD_DIMS",
    "collate",
    "get_iemocap_loaders",
    "get_meld_loaders",
    "write_synthetic_iemocap",
    "write_synthetic_meld",
]
