"""Find everything one cell needs by the names in ``BENCHMARK.json``.

    configs/<config>.json       the deployment: patterns, driver, settings
    syntax/<syntax>.py          to_regex(text): the configuration's patterns
    drivers/<driver>.py         build, call, instrument, snapshot: the
                                system under test
    traffic/<traffic>.json      the traffic mix: its generator and parameters
    generators/<generator>.py   make_pool(config, mix, seed)
    cells/<cell>.json           the limits of the cell's check
    metrics/<metric>.py         read(run) -> the metric's value, or None

A later cell, mix or metric adds files and manifest entries; no file here
changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: tuple   # manifest entries this cell reports, trace off
    per_layer: tuple    # ... and with the trace on


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py``, loaded by its path."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def regexes(config: dict) -> dict:
    """{pattern name: regex text}: the configuration's patterns through its
    ``syntax`` module.  The system under test and the reference both get
    these texts."""
    syntax = load_module("syntax", config["syntax"])
    return {name: syntax.to_regex(text)
            for name, text in config["patterns"].items()}


def driver(config: dict) -> ModuleType:
    """The configuration's ``drivers/<driver>.py``."""
    return load_module("drivers", config["driver"])


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``."""
    return cell in entry.get("workloads", [cell])


def resolve(name: str, root: Path = ROOT) -> Cell:
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(Path(root) / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        mix=_json(PKG / "traffic" / f"{w['traffic']}.json"),
        limits=_json(PKG / "cells" / f"{name}.json")["limits"],
        end_to_end=tuple(m for m in manifest["end_to_end"]
                         if reports(m, name)),
        per_layer=tuple(m for m in manifest["per_layer"]
                        if reports(m, name)))
