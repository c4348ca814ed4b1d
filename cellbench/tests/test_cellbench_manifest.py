"""BENCHMARK.json against the benchmark's rules: names, units, the files
it names, and the per-layer metrics' readers."""

import json

import pytest

from cellbench.manifest import NAME_RE, ROOT, UNIT_RE, Manifest

MAN = Manifest()
DATA = MAN.data


def test_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["cellbench"]
    assert 1 <= len(DATA["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in DATA["command"])
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len(json.dumps(DATA)) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in DATA[key]]
    names += [w["config"] for w in DATA["workloads"]] + [w["traffic"] for w in DATA["workloads"]]
    names += [k for c in DATA["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME_RE.match(n), n
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in DATA[key]}) == len(DATA[key]), key
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in DATA["workloads"]] + [c["why"] for c in DATA["configs"]] + \
            [c["source"] for c in DATA["configs"]] + [m["layer"] for m in DATA["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_and_bounds():
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_each_cell_reports_enough():
    for w in DATA["workloads"]:
        e2e = {m["name"] for m in MAN.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w
        assert MAN.per_layer(w["name"]), w
        assert w["chips"] in (1, 4)


def test_per_layer_moves_what_its_cells_report():
    for m in DATA["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in DATA["workloads"]])
        for cell in cells:
            assert m["moves"] in {e["name"] for e in MAN.end_to_end(cell)}, (m["name"], cell)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["per_layer"]])
def test_reader_declares_what_the_manifest_says(metric):
    entry = next(m for m in DATA["per_layer"] if m["name"] == metric)
    reader = MAN.reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == \
        (entry["unit"], entry["layer"], entry["moves"], entry["source"])
    assert reader.TRACED is True and callable(reader.read)


def test_files_named_exist_and_configs_hold_their_keys():
    for c in DATA["configs"]:
        assert c["file"].startswith("cellbench/")
        cfg = MAN.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for key in ("detector", "crop_net", "precision", "control_precision", "tracker", "limits", "assumed"):
            assert key in cfg, (c["name"], key)
    for w in DATA["workloads"]:
        assert (ROOT / "cellbench" / "traffic" / f"{w['traffic']}.json").exists()
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files)
