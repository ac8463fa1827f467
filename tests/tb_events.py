"""Read TensorBoard event files back for the ``--tensorboard`` tests: each
scalar tag's and each histogram tag's steps, in file order.  Needs the
``tensorboard`` package (the tests ``importorskip`` it)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple


def read_events(logdir) -> Tuple[Dict[str, List[int]], Dict[str, List[int]]]:
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    scalars: Dict[str, List[int]] = {}
    hists: Dict[str, List[int]] = {}
    for path in sorted(Path(logdir).glob("events.out.tfevents.*")):
        for event in EventFileLoader(str(path)).Load():
            for value in event.summary.value:  # migrated to tensors with a plugin name
                kind = value.metadata.plugin_data.plugin_name
                {"scalars": scalars, "histograms": hists}[kind].setdefault(
                    value.tag, []).append(event.step)
    return scalars, hists
