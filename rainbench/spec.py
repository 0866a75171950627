"""What the harness finds by name: ``BENCHMARK.json`` at the checkout's
root, and under ``rainbench/`` one file for each configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell's
correctness limits (``limits/<cell>.json``), per-layer metric
(``metrics/<name>.py``, a reader) and kernel count
(``counts/<kernel>.py``). A new one is a new file: nothing here lists
them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(HERE / "limits" / f"{cell}.json")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "rainbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader module of a per-layer metric (its ``read``)."""
    return _module(HERE / "metrics" / f"{metric}.py")


def count(kernel: str):
    """The count module of a kernel (its ``NAME``, ``COUNTER`` and
    ``count``)."""
    return _module(HERE / "counts" / f"{kernel}.py")


def counted_kernels() -> List[str]:
    return sorted(p.stem for p in (HERE / "counts").glob("*.py"))


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads, with its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def has_limits(cell: str) -> bool:
    return (HERE / "limits" / f"{cell}.json").exists()


def cell(name: str, held: bool = True) -> Cell:
    """The cell ``name`` of BENCHMARK.json; with ``held`` False, without
    its limits (to read the numbers they are set from)."""
    bench = benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(name=name, chips=int(w["chips"]),
                        config=config(w["config"]),
                        traffic=traffic(w["traffic"]),
                        limits=limits(name) if held else {"numbers": {}},
                        end_to_end=[m for m in bench["end_to_end"]
                                    if _applies(m, name)],
                        per_layer=[m for m in bench["per_layer"]
                                   if _applies(m, name)])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
