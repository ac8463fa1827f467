"""The data of every entry point and of the library-only datasets: the
IEMOCAP, AVEC, MELD and DailyDialog datasets, the bucketed loaders and the
synthetic fixture writers (numpy only)."""

from .datasets import (
    AVECDataset,
    DailyDialogueDataset,
    Dialogue,
    IEMOCAPDataset,
    MELDDataset,
    TokenDialogue,
)
from .loaders import (
    DEFAULT_BUCKETS,
    Batch,
    BucketedLoader,
    TokenBatch,
    TokenBucketedLoader,
    collate,
    collate_token_dialogues,
    get_avec_loaders,
    get_dailydialogue_loaders,
    get_iemocap_loaders,
    get_meld_loaders,
    head_tail_split,
)
from .synthetic import (
    IEMOCAP_DIMS,
    MELD_DIMS,
    write_synthetic_avec,
    write_synthetic_dailydialogue,
    write_synthetic_iemocap,
    write_synthetic_meld,
)

__all__ = [
    "AVECDataset",
    "Batch",
    "BucketedLoader",
    "DEFAULT_BUCKETS",
    "DailyDialogueDataset",
    "Dialogue",
    "IEMOCAPDataset",
    "IEMOCAP_DIMS",
    "MELDDataset",
    "MELD_DIMS",
    "TokenBatch",
    "TokenBucketedLoader",
    "TokenDialogue",
    "collate",
    "collate_token_dialogues",
    "get_avec_loaders",
    "get_dailydialogue_loaders",
    "get_iemocap_loaders",
    "get_meld_loaders",
    "head_tail_split",
    "write_synthetic_avec",
    "write_synthetic_dailydialogue",
    "write_synthetic_iemocap",
    "write_synthetic_meld",
]
