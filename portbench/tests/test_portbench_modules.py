"""No run imports JAX or the JAX package; the reference imports nothing of
the program. Top-level module names are compared whole, so
``macaque_tpu_torch`` is not ``macaque_tpu``."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    last = _python(
        "import time\n"
        "from portbench_tiny import tiny_cell\n"
        "from portbench import harness\n"
        "harness.run_cell(tiny_cell(), 5, 0.1, True, 'cpu', time.perf_counter())\n"
        "import sys\n"
        "assert 'macaque_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    assert last == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "macaque_tpu_torch_probe",
                        types.ModuleType("macaque_tpu_torch_probe"))
    monkeypatch.delitem(sys.modules, "macaque_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    before = harness.forbidden_modules()
    assert "macaque_tpu" not in before and "jax" not in before
    monkeypatch.setitem(sys.modules, "macaque_tpu.nn", types.ModuleType("m"))
    assert "macaque_tpu" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    last = _python(
        "import sys\n"
        "import portbench.check, portbench.weights\n"
        "from portbench import files\n"
        "from portbench.reference import detect, lowp, nets, prep, track\n"
        "for b in files.load_json('configs/parity.json')['networks'].values():\n"
        "    files.arch(b).reference(files.arch(b).tiny(b))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'macaque_tpu_torch', 'macaque_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    assert last == "[]"
