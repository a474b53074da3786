"""The benchmark's description: BENCHMARK.json, and the data files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric sits in a file of its own under gpu_bench/,
found by the name BENCHMARK.json gives it:

  configs/<config>.json     the model configuration as it is run
  traffic/<traffic>.json    the traffic mix's parameters (harness/traffic.py)
  limits/<cell>.json        the limits of the comparison that decides `correct`
  metrics/<metric>.py       the per-layer metric's reader; a dotted name such
                            as device_idle_pct.eval falls back to the reader
                            of its stem, metrics/device_idle_pct.py
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_PATH = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads, with its files read."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell `name` of BENCHMARK.json: its configuration, traffic and
    limits files, and the metrics it reports (a metric without a
    `workloads` key is reported by every cell that reports what it moves)."""
    spec = load_json(SPEC_PATH) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {SPEC_PATH.name}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic,
                limits, e2e, per_layer)


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: metrics/<name>.py, else the reader
    of the name's stem before its first dot."""
    exact = BENCH_DIR / "metrics" / f"{metric}.py"
    if exact.exists():
        return exact
    return BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"


def check_names(spec: Dict[str, Any]) -> List[str]:
    """The names and units of BENCHMARK.json that break the contract's
    character rules (an empty list when all keep them)."""
    bad = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[section]:
            if not NAME_RE.match(entry["name"]):
                bad.append(f"{section}: name {entry['name']!r}")
            if "unit" in entry and not UNIT_RE.match(entry["unit"]):
                bad.append(f"{section}: unit {entry['unit']!r}")
    for w in spec["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                bad.append(f"workloads: {key} {w[key]!r}")
    for c in spec["configs"]:
        for key in c["reduced"]:
            if not NAME_RE.match(key):
                bad.append(f"configs: reduced key {key!r}")
    return bad
