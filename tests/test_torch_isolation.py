"""The port stands alone: no file of ``macaque_tpu_torch`` nor
``chip_smoke.py`` imports JAX, Flax or the JAX package; ``cv2``, ``yaml``
and ``triton`` are imported only inside functions; and the port, with
every module ``chip_smoke.py`` imports, imports with jax, flax, cv2 and
yaml all unavailable (as on the machine with the card)."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "macaque_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "macaque_tpu"}
LAZY = {"cv2", "yaml", "triton"}


def _sources():
    out = [SMOKE]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(top-level module name, node) for every import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_lazy_optional_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [n for n, _ in _imports(tree)]
    assert not FORBIDDEN & set(names), f"{path} imports {FORBIDDEN & set(names)}"
    top = {n for n, node in _imports(ast.Module(body=tree.body, type_ignores=[]))
           if node in tree.body}
    assert not LAZY & top, f"{path} imports {LAZY & top} at module level"


def test_port_imports_without_jax_cv2_yaml():
    with open(SMOKE) as f:
        smoke_mods = sorted({(n.module if isinstance(n, ast.ImportFrom) else a.name)
                             for n in ast.walk(ast.parse(f.read()))
                             if isinstance(n, (ast.Import, ast.ImportFrom))
                             for a in n.names})
    port_mods = ["macaque_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PORT], "macaque_tpu_torch.")]
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'cv2', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {port_mods + smoke_mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('macaque_tpu', 'jax', 'flax') and sys.modules[m] is not None]\n"
        "print('isolated', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result;
    copied alone into an empty directory it fails as well."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(SMOKE).read())
    for script, cwd in ((SMOKE, ROOT), (str(lone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
