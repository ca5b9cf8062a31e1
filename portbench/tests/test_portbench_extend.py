"""A later change adds a cell and a per-layer metric as new files and
entries only: in a copy of the benchmark, a new traffic mix, a cell's
limits, a metric reader and their entries in BENCHMARK.json run through
the unchanged harness (on the CPU, against a tiny model)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_new_cell_and_metric_need_no_edit(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(os.path.join(ROOT, "portbench"), copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = copy / "portbench"
    traffic = json.loads((pb / "traffic" / "train_b64.json").read_text())
    traffic.update(B=2, bucket=32, distinct=3)
    (pb / "traffic" / "train_tiny.json").write_text(json.dumps(traffic))
    limits = json.loads((pb / "cells" / "train.universal4.json").read_text())
    (pb / "cells" / "train.tiny.json").write_text(json.dumps(limits))
    (pb / "metrics" / "dummy.steps.py").write_text(textwrap.dedent('''
        """Steps in the traced window."""


        def read(run):
            return float(run.window["units"])
    '''))
    b = json.loads((copy / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "train.tiny", "config": "universal4",
                           "traffic": "train_tiny", "chips": 1,
                           "why": "a dummy cell"})
    for m in b["end_to_end"]:
        if m["name"] == "train_fps":
            m["workloads"].append("train.tiny")
    b["per_layer"].append({"name": "dummy.steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "model", "moves": "train_fps",
                           "workloads": ["train.tiny"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    script = textwrap.dedent(f'''
        import json, sys, time
        sys.path.insert(0, {str(copy)!r})
        sys.path.insert(1, {ROOT!r})
        from portbench import harness
        from portbench.tests import tiny
        assert harness.HERE == harness.ROOT / "portbench"
        assert str(harness.ROOT) == {str(copy)!r}

        class Patch:
            def setattr(self, obj, name, value):
                setattr(obj, name, value)

        d, conf = tiny.make_assets({str(tmp_path)!r},
                                   "portbench/configs/universal4.json")
        tiny.point_program_at(Patch(), d)
        r = harness.run_cell("train.tiny", 5, 2.0, True, time.perf_counter(),
                             device="cpu", assets_dir=d,
                             overrides={{"conf": conf}})
        print(json.dumps(r))
    ''')
    out = subprocess.run([sys.executable, "-c", script], cwd=copy,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["metrics"]["dummy.steps"]["value"] >= 1
    # the cell reports the per-layer metrics that list it, and no other
    assert set(r["metrics"]) == {"dummy.steps"}
