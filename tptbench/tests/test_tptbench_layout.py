"""BENCHMARK.json resolves, by name, to the files of tptbench/."""

import json
import os
import re

import pytest

from tptbench import camera_path, check, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])


def test_configs_resolve(bench):
    for c in bench["configs"]:
        with open(os.path.join(run.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["limits"]) >= {"rel_l1", "off_px_share"}


def test_cells_resolve(bench):
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        spec = run.cell_spec(bench, w["name"])
        camera_path.camera_path(spec["traffic"]["camera"], 1)
        check.modelled(spec["config"])
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        for m in spec["end_to_end"]:
            assert callable(run.reader(m["name"]).window)
        for m in spec["per_layer"]:
            assert callable(run.reader(m["name"]).read)
            assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_command_names_only_the_harness(bench):
    assert bench["command"] == ["python3", "-m", "tptbench.run"]
    assert bench["paths"] == ["tptbench"]
