"""A later change adds a configuration, a traffic mix, a per-layer metric
and a kernel bound as new files under ``portbench/`` and entries in
``BENCHMARK.json``, and the harness finds each by its name without an
edit to any file it already had."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

METRIC = '''from portbench.files import load_module


def read(run, trace):
    k = load_module("rooflines/kx.py")
    return k.FACTOR * sum(len(run.frames) for s in run.segments if s[0] >= 0)
'''


def _digests(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if "__pycache__" not in d:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digests(pb)
    (pb / "configs" / "parity_b.json").write_text(
        (pb / "configs" / "parity.json").read_text())
    mix = json.loads((pb / "mixes" / "occupied.json").read_text())
    (pb / "mixes" / "busy.json").write_text(json.dumps(dict(mix, fg_bias=5.0)))
    (pb / "metrics" / "loop.frames_seen.py").write_text(METRIC)
    (pb / "rooflines" / "kx.py").write_text("FACTOR = 2\n")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append(dict(spec["configs"][0], name="parity_b",
                                file="portbench/configs/parity_b.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="parity_b.busy",
                                  config="parity_b", traffic="busy"))
    spec["per_layer"].append({"name": "loop.frames_seen", "unit": "cf",
                              "better": "higher", "source": "program_counter",
                              "layer": "camera loop and tracker",
                              "moves": "stage1_cf_s",
                              "workloads": ["parity_b.busy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(pb)
    assert all(after[k] == v for k, v in before.items())
    code = (
        "import json, time\n"
        "from portbench_tiny import tiny_cell\n"
        "from portbench import harness, files\n"
        f"cell = tiny_cell('parity_b.busy', root={str(tmp_path)!r})\n"
        "assert files.HERE.startswith(%r)\n" % str(tmp_path) +
        "assert cell['mix']['fg_bias'] == 5.0\n"
        "r, _ = harness.run_cell(cell, 3, 0.1, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps(r['metrics']['loop.frames_seen']))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), HERE, ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    value = json.loads(out.stdout.strip().splitlines()[-1])
    assert value["unit"] == "cf" and value["value"] >= 2 * 4
