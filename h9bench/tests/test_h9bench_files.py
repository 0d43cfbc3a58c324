"""``BENCHMARK.json`` and the files it names: each parses, is found by
name, and keeps to the limits of the benchmark's contract."""

import ast
import os
import re

import pytest

from tiny import ROOT, load

BENCH = load("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")
#: Keys that name a width: never cut.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_token)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h9bench/run.py"]
    assert BENCH["paths"] == ["h9bench"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_entries_keep_to_the_contract():
    metric_keys = {"name", "unit", "better", "source"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h9bench/configs/")
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            for key in TEXT_KEYS:
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200, (entry["name"], key)
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_enough():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in cells:
        mine = [m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert layer
        for m in layer:
            assert m["moves"] in mine
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_run_seconds_fit_a_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    from h9bench import harness, traffic

    spec = harness.cell_spec(BENCH, cell)
    config = load(spec["config"]["file"])
    assert config["name"] == spec["config"]["name"]
    assert config["reduced"] == spec["config"]["reduced"]
    workload = load(f"h9bench/workloads/{spec['cell']['traffic']}.json")
    assert workload["kind"] in traffic.KINDS
    limits = load(f"h9bench/limits/{cell}.json")
    assert limits and all(v > 0 for v in limits.values())
    for m in spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)


def test_every_metric_reader_is_named_in_the_benchmark():
    readers = {f[:-3] for f in os.listdir(os.path.join(ROOT, "h9bench",
                                                       "metrics"))
               if f.endswith(".py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "hybrid9_tpu", "bench",
                 "__graft_entry__"}
    found = []
    for base, _, files in os.walk(os.path.join(ROOT, "h9bench")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                found += [(path, m) for m in _top_level_imports(path)
                          if m in forbidden]
    assert not found
    for m in BENCH["per_layer"]:
        span = getattr(__import__("h9bench.harness").harness.load_reader(
            m["name"]), "SPAN", None)
        if span:
            assert span[0].split(".")[0] == "hybrid9_tpu_torch"
