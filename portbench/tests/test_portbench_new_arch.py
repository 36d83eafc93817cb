"""A later change adds a network architecture as new files alone: an
architecture file under ``archs/``, a configuration whose network block
names it under ``arch_file``, the new cell's limits, and the cell in
``BENCHMARK.json``. The harness, the weights and the check find it by
that name without an edit to any file the benchmark already had."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from test_portbench_discovery import _digests

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# Swin-S Mask R-CNN's builders under a new name, with one initialization
# rule for a key suffix that no rule of ``weights.py`` covers
ARCH = '''"""Swin-S Mask R-CNN under a new name, with one more rule."""
import sys

from portbench.files import load_module

_swin = load_module("archs/swin_mask_rcnn.py")
FG_BIAS = _swin.FG_BIAS
INIT = dict(_swin.INIT, rel_pos_h="ones")
loaded, perception_kwargs = _swin.loaded, _swin.perception_kwargs
reference, quantize = _swin.reference, _swin.quantize
reference_input, input_hw, tiny = _swin.reference_input, _swin.input_hw, _swin.tiny


def program(block, dtype, device):
    print("swin_relpos: program", file=sys.stderr)
    return _swin.program(block, dtype, device)
'''

RUN = '''import json, time
import torch
from portbench_tiny import tiny_cell
from portbench import files, harness
from portbench.weights import seeded_state

assert files.HERE.startswith(%(tmp)r)
cell = tiny_cell("parity_relpos.occupied", root=%(tmp)r)
block = cell["config"]["networks"]["detector"]
assert block["arch_file"] == "archs/swin_relpos.py"
r, lines = harness.run_cell(cell, 2 ** 31 + 321, 0.1, True, "cpu",
                            time.perf_counter())


class Toy(torch.nn.Module):
    """A reference whose attention carries the new suffix."""

    def __init__(self):
        super().__init__()
        self.attn = torch.nn.Linear(4, 6)
        self.attn.rel_pos_h = torch.nn.Parameter(torch.zeros(13, 2))


sd = seeded_state("detector", block, 5, "cpu", net=Toy())
print(json.dumps({"correct": r["correct"], "lines": [list(l) for l in lines],
                  "metrics": sorted(r["metrics"]),
                  "rel_pos_h": sd["attn.rel_pos_h"].tolist(),
                  "weight_max": sd["attn.weight"].abs().max().item(),
                  "keys": list(sd)}))
'''


def test_a_new_architecture_joins_as_new_files(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digests(pb)
    (pb / "archs" / "swin_relpos.py").write_text(ARCH)
    cfg = json.loads((pb / "configs" / "parity.json").read_text())
    cfg["name"] = "parity_relpos"
    cfg["networks"]["detector"]["arch_file"] = "archs/swin_relpos.py"
    (pb / "configs" / "parity_relpos.json").write_text(json.dumps(cfg, indent=1))
    (pb / "limits" / "parity_relpos.occupied.json").write_text(
        (pb / "limits" / "parity.occupied.json").read_text())
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append(dict(spec["configs"][0], name="parity_relpos",
                                file="portbench/configs/parity_relpos.json"))
    spec["workloads"].append(dict(spec["workloads"][0],
                                  name="parity_relpos.occupied",
                                  config="parity_relpos"))
    for m in spec["per_layer"]:
        if "parity.occupied" in m.get("workloads", []):
            m["workloads"].append("parity_relpos.occupied")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(pb)
    assert all(after[k] == v for k, v in before.items())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), HERE, ROOT]))
    out = subprocess.run([sys.executable, "-c", RUN % {"tmp": str(tmp_path)}],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "swin_relpos: program" in out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"], got["lines"]
    listed = {m["name"] for m in spec["per_layer"]
              if "parity_relpos.occupied" in m.get("workloads", [])}
    assert {"perception.detect_ms_per_cf", "networks.trunk_host_ms_per_cf"} \
        <= set(got["metrics"]) <= listed
    # the new rule set the new suffix; the weights' own rules the rest
    assert got["rel_pos_h"] == [[1.0, 1.0]] * 13
    assert 0 < got["weight_max"] <= 0.5
    assert got["keys"] == ["attn.weight", "attn.bias", "attn.rel_pos_h"]


def test_a_block_without_an_arch_file_is_an_error():
    from portbench import files
    from portbench.weights import seeded_state

    block = dict(files.load_json("configs/parity.json")["networks"]["pose"])
    del block["arch_file"]
    with pytest.raises(KeyError, match="arch_file"):
        files.arch(block)
    with pytest.raises(KeyError, match="arch_file"):
        seeded_state("pose", block, 1, "cpu")
