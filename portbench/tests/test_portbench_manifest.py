"""BENCHMARK.json: every part found by name in its own file, and the form
the benchmark's contract asks for."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest  # noqa: E402

M = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in M["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_part_by_name(name):
    cell = manifest.resolve(name)
    regexes = manifest.regexes(cell.config)
    assert regexes and list(regexes) == list(cell.config["patterns"])
    drv = manifest.driver(cell.config)
    for fn in ("build", "call", "instrument", "snapshot", "table_bytes"):
        assert callable(getattr(drv, fn))
    gen = manifest.load_module("generators", cell.mix["generator"])
    assert callable(gen.make_pool)
    assert set(cell.limits) == {"wrong_decisions", "unanswered_calls"}
    for entry in cell.end_to_end + cell.per_layer:
        assert callable(manifest.load_module("metrics", entry["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_top_level_form():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (ROOT / p).is_dir()
        assert not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert any(M["command"][1].startswith(p + "/") for p in M["paths"])
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells, 14 runs each, fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
    pairs = set()
    assert 1 <= len(M["workloads"]) <= 24
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(CELLS)) == len(CELLS)


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in SOURCES
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and manifest.reports(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
