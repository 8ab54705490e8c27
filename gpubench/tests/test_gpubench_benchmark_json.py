"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by."""
import json
import re

import pytest

from _small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_texts(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (key, e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key), key


def test_configs_exist_and_state_their_cuts():
    from gpubench.harness.population import experiment_config
    from dist_dqn_tpu_torch.config import CONFIGS
    import dataclasses
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("gpubench/")
        data = json.loads(path.read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        # Each departure from the source gives the source's value.
        assert sorted(data["paper_values"]) == sorted(c["reduced"])
    # Every configuration file is its port preset with exactly the keys
    # it names in from_preset changed, each of them also a departure
    # from the source.
    for path in sorted((ROOT / "gpubench" / "configs").glob("*.json")):
        data = json.loads(path.read_text())
        preset = dataclasses.asdict(CONFIGS[data["port_preset"]])
        mine = dataclasses.asdict(experiment_config(data["experiment"]))
        changed = sorted(f"{s}.{k}" for s in ("network", "replay",
                                              "learner", "actor")
                         for k in preset[s] if preset[s][k] != mine[s][k])
        assert changed == sorted(data["from_preset"]), path.name
        assert set(changed) <= set(data["reduced"]), path.name


def test_cells_find_their_files():
    from gpubench.harness import cell
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        c = cell.cell(w["name"], BENCH)
        assert c["traffic"]["members"] == len(c["traffic"]["lr_scale"])
        assert c["limits"], w["name"]
        assert c["end_to_end"] and c["per_layer"]
        assert any(m["name"] == "setup_s" for m in c["end_to_end"])


def test_metrics_have_readers_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
