"""BENCHMARK.json and the files its cells name: every cell resolves by
name, a cell added as data alone is found, names and units keep to their
characters, and no module of the benchmark imports JAX or the JAX
package."""

import ast
import json
import os
import re
import shutil

import pytest

from benchmark.harness import cell as cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_JSON = os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(BENCH_JSON) as f:
        return json.load(f)


@pytest.mark.parametrize("workload",
                         [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves(workload):
    c = cells.load(workload)
    assert c.config["name"] == c.spec["config"]
    assert c.traffic["name"] == c.spec["traffic"]
    assert c.family.EvalProgram and c.family.TrainProgram
    assert c.driver.run and c.driver.readings
    # an exact comparison has the limit 0
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert all(m["moves"] in {e["name"] for e in c.end_to_end}
               for m in c.per_layer)


def test_cell_added_as_data_is_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root)
    bench = _bench()
    new = dict(bench["workloads"][0], name="added-as-data")
    bench["workloads"].append(new)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    shutil.copy(root / "checks" / (bench["workloads"][0]["name"] + ".json"),
                root / "checks" / "added-as-data.json")
    c = cells.load("added-as-data", str(tmp_path / "BENCHMARK.json"),
                   str(root))
    assert c.spec == new
    assert c.config["name"] == new["config"]
    with pytest.raises(KeyError):
        cells.load("not-a-cell", str(tmp_path / "BENCHMARK.json"), str(root))


def test_names_and_units():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for c in b["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] +
               b["per_layer"])
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    texts = [c["why"] for c in b["configs"] + b["workloads"]] + \
        [c["source"] for c in b["configs"]] + \
        [m["layer"] for m in b["per_layer"]] + b["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    assert os.path.getsize(BENCH_JSON) <= 64 * 1024
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _modules(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _modules():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "heltondetection_tpu"}, \
            path


def test_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "heltondetection_tpu_torch" not in tops, path
