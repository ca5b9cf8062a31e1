"""``BENCHMARK.json`` against the benchmark contract's rules of form, the
files the harness finds by name, and the import rule: nothing the card runs
loads JAX, its libraries or the JAX package, and the reference and the
frozen copies load nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(b["command"]) <= 32
    assert all(text_ok(w) for w in b["command"])
    assert os.path.exists(os.path.join(ROOT, b["command"][1]))
    assert b["command"][1].startswith(tuple(p + "/" for p in b["paths"]))
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert text_ok(m["layer"])
    names = [x["name"] for k in ("configs", "workloads") for x in b[k]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(set(x["name"] for x in b["configs"])) == len(b["configs"])
    assert len(set(x["name"] for x in b["workloads"])) == len(b["workloads"])
    assert names


def test_cells_report_what_the_contract_asks():
    b = bench()
    cfgs = {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert w["config"] in cfgs
        n = w["name"]
        mine = [m["name"] for m in b["end_to_end"]
                if n in m.get("workloads", [n])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(n in m.get("workloads", [n]) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for n in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert n in e2e[m["moves"]].get("workloads", [n])
    assert {c for c in cfgs} == {w["config"] for w in b["workloads"]}


def test_files_found_by_name():
    b = bench()
    files = set()
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert conf["source"] == c["source"]
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(PB, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(PB, "cells", w["name"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(PB, "metrics", m["name"] + ".py"))


def test_layer_names_are_consistent():
    """Metrics of one layer name it letter for letter."""
    layers = {m["layer"] for m in bench()["per_layer"]}
    folded = {x.lower().replace(" ", "") for x in layers}
    assert len(folded) == len(layers)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _py_files(*parts):
    base = os.path.join(PB, *parts)
    for d, _, fs in os.walk(base):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, PB))
def test_no_jax_anywhere(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                         "lipreading_tpu"), mod


@pytest.mark.parametrize(
    "path", sorted([*_py_files("ref"), *_py_files("frozen")]),
    ids=lambda p: os.path.relpath(p, PB))
def test_reference_and_copies_import_nothing_of_the_program(path):
    for mod in _imports(path):
        assert mod.split(".")[0] != "lipreading_tpu_torch", mod
