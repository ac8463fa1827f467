"""Masked classification metrics and the test report (numpy only)."""

from .metrics import (accuracy_score, classification_report, confusion_matrix, f1_score,
                      precision_recall_fscore_support)
from .reports import format_test_report, write_test_report

__all__ = [
    "accuracy_score",
    "classification_report",
    "confusion_matrix",
    "f1_score",
    "format_test_report",
    "precision_recall_fscore_support",
    "write_test_report",
]
