"""A cell of ``BENCHMARK.json`` and the files that make it, each found by
its name, so that a later cell, configuration, traffic mix, kind of work or
metric is a new file and no file here is edited:

- ``configs/<config>.json`` (the manifest's ``file``): the configuration;
- ``traffic/<mix>.json``: the traffic mix, data alone; its ``kind`` names
  the module ``kinds/<kind>.py`` that reads it (see ``kinds/__init__.py``);
- ``limits/<cell>.json``: the limit of each number that the cell's
  comparison gives;
- ``metrics/<metric>.py``: one reader a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys put in, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as the module ``name`` (a name may hold
    dots and dashes, so a file is loaded by its path)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return f"benchmark.{kind}." + "".join(c if c.isalnum() else "_"
                                          for c in name)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       _modname("metrics", name)).read


def kind_module(kind: str) -> ModuleType:
    """``kinds/<kind>.py``."""
    path = HERE / "kinds" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"no kind of work {kind!r} (kinds/{kind}.py)")
    return load_module(path, _modname("kinds", kind))


def load_limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


@dataclasses.dataclass
class Cell:
    """One cell: its configuration (``override`` merged in: the tests'
    small sizes) and its traffic mix, and the module of the mix's kind."""
    name: str
    cfg: dict
    traffic: dict
    kind: ModuleType


def load_cell(manifest: dict, name: str, override: dict | None = None) -> Cell:
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    cfg = merge(load_json(ROOT / conf["file"]), override or {})
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return Cell(name, cfg, traffic, kind_module(traffic["kind"]))


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list:
    """The metrics that the cell reports: its end-to-end ones, or with a
    trace its per-layer ones."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]
