"""What a cell is made of, found by the names in ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<name>.json``), the
protocol module the configuration names (``protocols/<protocol>.py``), the
entry module the traffic names (``entries/<entry>.py``), the readers of
its per-layer metrics (``metrics/<metric>.py``) and the kernel families
(``roofline/kernels/<family>.py``) that those readers name. A new cell,
configuration, traffic mix, metric or kernel is new files and new entries,
never an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path

    @property
    def batch(self) -> int:
        """Lanes a batch has on one card."""
        return self.traffic.get("batch", self.config["batch_per_card"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; an unknown name raises
    KeyError."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    bench_dir = root / Path(bench["paths"][0])
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], bench_dir)


def protocol(cell: Cell):
    return importlib.import_module(f"benchmark.protocols.{cell.config['protocol']}")


def entry(cell: Cell):
    return importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, name: str):
    """The reader module of the per-layer metric ``name``."""
    return _load_file(cell.root / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def kernel_families(cell: Cell) -> dict:
    """{family: module} of the kernel families that the cell's per-layer
    readers name (their ``FAMILY``): only these have their launches
    recorded in the profiled stretch."""
    out = {}
    for m in cell.per_layer:
        fam = getattr(metric_reader(cell, m["name"]), "FAMILY", None)
        if fam is not None:
            out[fam.__name__.rsplit(".", 1)[1]] = fam
    return out
