"""The measurement path refuses to run without a card, and outside a
checkout that holds the program; it prints no result either way."""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ARGS = ["--workload", "parity.occupied", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict)
        except json.JSONDecodeError:
            pass


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and "macaque_tpu_torch" in out.stderr
    _no_result(out)
