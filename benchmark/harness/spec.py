"""``BENCHMARK.json`` and the files a cell is made of, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives it; the traffic mix is
``traffic/<traffic>.json``; the limits of the comparison that decides
``correct`` are ``limits/<cell>.json``; an end-to-end metric is read by
``end_to_end/<name>.py`` and a per-layer metric by ``metrics/<name>.py``.
Each reader module defines ``read(run)``, which returns a number or None
(nothing to read). A new cell or metric is new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder
REPO = HERE.parent


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration's file as run, with its ``name``."""
    entry = _by_name(bench["configs"], name, "configuration")
    with open(REPO / entry["file"], encoding="utf-8") as f:
        return dict(json.load(f), name=name)


def _json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts), encoding="utf-8") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return dict(_json("traffic", f"{name}.json"), name=name)


def limits(cell_name: str) -> dict:
    return _json("limits", f"{cell_name}.json")


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports: those that list it, and those
    that list no cells."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics read in a cell's traced run: those whose
    ``workloads`` list it (every per-layer metric lists its cells)."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


_readers: dict = {}


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py`` (kind "end_to_end" or
    "metrics"), loaded from its file: a name may hold dots."""
    key = (kind, name)
    if key not in _readers:
        path = HERE / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[key] = mod.read
    return _readers[key]
