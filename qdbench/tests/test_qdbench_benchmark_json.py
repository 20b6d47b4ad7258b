"""``BENCHMARK.json``'s format: its keys, names and
units, and a file for every configuration, mix, entry and reader."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "qdbench/run.py"]
    assert BENCH["paths"] == ["qdbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_keys(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("qdbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "qdbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert NAME.fullmatch(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "qdbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in cells and cell in reported, (m["name"], cell)
    for cell in cells:
        own = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(own) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_every_mix_names_an_entry():
    from qdbench import stream

    for path in (ROOT / "qdbench" / "traffic").glob("*.json"):
        mix = stream.load_mix(path.stem)
        assert (ROOT / "qdbench" / "entries" / f"{mix['entry']}.py").is_file()
        assert line(mix["why"])
