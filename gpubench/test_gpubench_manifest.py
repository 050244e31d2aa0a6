"""BENCHMARK.json against the contract's form, and the harness finding
every configuration, traffic mix, limit and metric by name."""

import json
import re
import shutil

import pytest

from gpubench import harness, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def _line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_form(man):
    assert set(man) == KEYS["top"]
    assert 1 <= len(man["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in man["paths"])
    assert len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[section]]
        assert len(names) == len(set(names)), section
        for e in man[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in man["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    for m in man["per_layer"]:
        assert _line(m["layer"]) and m["source"] in ("device_trace", "program_span", "program_counter",
                                                     "host_clock")
    assert len(json.dumps(man)) <= 64 * 1024


def test_every_name_finds_its_files(man):
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        assert c["file"].startswith("gpubench/")
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in man["workloads"]:
        traffic = harness.data("traffic", w["traffic"])
        assert harness.driver(traffic).setup
        limits = harness.data("limits", w["name"])
        assert all(isinstance(v, float) for k, v in limits.items() if k != "why")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in e2e
        for w in m.get("workloads", [w["name"] for w in man["workloads"]]):
            assert harness.applies(e2e[m["moves"]], w), (m["name"], w)
    for w in man["workloads"]:
        reported = [m for m in man["end_to_end"] if harness.applies(m, w["name"])]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(harness.applies(m, w["name"]) for m in man["per_layer"])


def test_a_cell_is_added_by_files_and_entries_alone(man, tmp_path, monkeypatch):
    """A new cell (another batch of the swap traffic) from a new traffic
    file, a new limits file and BENCHMARK.json entries: no file that is
    there changes."""
    for kind in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    traffic = json.loads((tmp_path / "traffic" / "testbench_b10.json").read_text())
    traffic.update(batch=3, pool_batches=1, check_pairs=2)
    (tmp_path / "traffic" / "testbench_b3.json").write_text(json.dumps(traffic))
    (tmp_path / "limits" / "swap64_b3.json").write_text(json.dumps({"share_off_3_levels": 0.0}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    new = json.loads(json.dumps(man))
    new["workloads"].append({"name": "swap64_b3", "config": "reface_sd14_512", "traffic": "testbench_b3",
                             "chips": 1, "why": "a test cell"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "swap512_b10" in m.get("workloads", []):
            m["workloads"].append("swap64_b3")
    cfg = tiny.tiny_config("swap512_b10")
    r = harness.run_cell("swap64_b3", 5, 0.0, False, "cpu", man=new, cfg=cfg)
    assert r["correct"] and r["attempted"] == 3
    assert set(r["metrics"]) == {"swaps_per_s", "peak_mem_gib", "setup_s"}
