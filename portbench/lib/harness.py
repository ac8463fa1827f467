"""What every run shares: the files that a cell is found by.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, whose ``entry`` names a module of ``entries/``
with the class ``Entry`` that owns the cell's set-up, window, end-to-end
readings and check, and each per-layer metric's reader in
``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from pathlib import Path
from typing import Dict, List, Mapping, Optional

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def load_bench() -> dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(f"configs/{name}.json")


def traffic(name: str) -> dict:
    return load_json(f"traffic/{name}.json")


def entry_class(kind: str):
    return importlib.import_module(f"portbench.entries.{kind}").Entry


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  ROOT / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(names: List[str], ctx: Mapping) -> Dict[str, Optional[float]]:
    """Each named per-layer metric's reading of a traced window's context;
    a metric whose reader finds nothing to read is left out."""
    out = {}
    for name in names:
        value = metric_reader(name)(ctx)
        if value is not None and math.isfinite(value):
            out[name] = value
    return out
