"""The port stands alone: no file of ``macaque_tpu_torch`` nor
``chip_smoke.py`` imports JAX, Flax or the JAX package; ``cv2``, ``yaml``,
``triton``, ``h5py``, ``networkx``, ``pandas`` and ``matplotlib`` are
imported only inside functions; and the port, with every module
``chip_smoke.py`` imports, imports with jax, flax, cv2, yaml, h5py,
networkx, pandas and matplotlib all unavailable (as on the machine with
the card)."""

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
LAZY = {"cv2", "yaml", "triton", "h5py", "networkx", "pandas", "matplotlib"}


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


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_networkx_anywhere(path):
    """The card machine has no networkx: step 3's min-cost flow is the
    port's own, and no function of the port imports networkx, not even
    lazily."""
    with open(path) as f:
        names = {n for n, _ in _imports(ast.parse(f.read(), path))}
    assert "networkx" not in names, f"{path} imports networkx"


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
        "for m in ('jax', 'jaxlib', 'flax', 'cv2', 'yaml', 'h5py', "
        "'networkx', 'pandas', 'matplotlib'):\n"
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


def test_pipeline_runs_without_cv2_or_yaml(tmp_path):
    """With jax, cv2, yaml, h5py, networkx, pandas and matplotlib blocked,
    as on the card's machine: RGBA stores are written and read, ``run_pipeline`` runs steps
    1-4 on them (render off), ``overlay_points`` projects, the demo's and
    the CLI's parsers build, and only the render's drawing asks for cv2."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'cv2', 'yaml', 'h5py', "
        "'networkx', 'pandas', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from macaque_tpu_torch import demo\n"
        "from macaque_tpu_torch import __main__ as cli\n"
        "from macaque_tpu_torch.core.config import PipelineConfig\n"
        "from macaque_tpu_torch.pipeline.artifacts import read_pickle\n"
        "from macaque_tpu_torch.pipeline.runner import run_pipeline\n"
        "from macaque_tpu_torch.tools import synthetic as s\n"
        "from macaque_tpu_torch.tools.visualize import (overlay_points, "
        "render_overlay)\n"
        f"root = {str(tmp_path)!r}\n"
        "rig = s.make_test_rig(4)\n"
        "truth = s.simulate_scene(2, 30, seed=1)\n"
        "proj = s.project_scene(rig, truth)\n"
        "s.render_stores(root + '/videos', 'synth', rig, proj, "
        "fourcc='RGBA', chunksize=16)\n"
        "cfg = PipelineConfig(data_name='synth', raw_data_dir=root + "
        "'/videos', results_dir=root + '/results')\n"
        "rd = run_pipeline(cfg, rig, lambda c: s.SyntheticPerception("
        "rig.camera_ids.index(c), proj), render=False, device='cpu')\n"
        "p, d = overlay_points(read_pickle(rd + '/kp3d.pickle'), rig, 0, "
        "device='cpu')\n"
        "assert np.isfinite(p).any() and d.any()\n"
        "try:\n"
        "    render_overlay('synth', 0, rd, root + '/videos', rig, "
        "device='cpu')\n"
        "    raise AssertionError('rendered without cv2')\n"
        "except ImportError:\n"
        "    pass\n"
        "cli.parser().parse_args(['pipeline'])\n"
        "demo.parser().parse_args(['--synthetic', '--device', 'cpu'])\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('macaque_tpu', 'jax', 'cv2', 'yaml') and sys.modules[m] is not "
        "None]\n"
        "print('pipeline ran', p.shape)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "pipeline ran" in proc.stdout


def test_eval2d_tools_run_without_cv2(tmp_path):
    """With cv2 and the rest blocked, as on the card's machine: the COCO
    evaluation's array core scores ``chip_smoke.py``'s numpy-drawn scene
    with the oracle, ``run_synthetic_sweep`` writes its recording as RGBA
    stores and runs steps 1-4 on them, the pictorial inference and the
    closure run, and only the file readers (``run_coco_eval``,
    ``render_2d_video``) ask for cv2."""
    code = (
        "import sys, glob\n"
        "for m in ('jax', 'jaxlib', 'flax', 'cv2', 'yaml', 'h5py', "
        "'networkx', 'pandas', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import chip_smoke\n"
        "from macaque_tpu_torch.association.pictorial import ("
        "closure_to_clusters, infer_pictorial_3d)\n"
        "from macaque_tpu_torch.tools import coco_eval, run2d, sweep\n"
        "from macaque_tpu_torch.tools.synthetic import SyntheticPerception\n"
        "proj, images, records = chip_smoke.coco_scene(8)\n"
        "res = coco_eval.coco_eval_arrays(SyntheticPerception(0, proj, "
        "noise=0.5), images, records, det_thr=0.5, progress=False)\n"
        "assert res['n_images'] == 8 and res['det']['AP50'] > 0.95, res\n"
        f"root = {str(tmp_path)!r}\n"
        "log = sweep.run_synthetic_sweep(root, grid=[sweep.SweepPoint()], "
        "n_frame=24, verbose=False, device='cpu')\n"
        "assert glob.glob(root + '/videos/synth.*/*.avi')\n"
        "assert len(sweep.rank_sweep(log)) == 1\n"
        "picks = infer_pictorial_3d(*(torch.zeros(s) for s in "
        "((13, 3), (13, 3, 3), (13,))), torch.ones(13))\n"
        "assert picks.tolist() == [0] * 13\n"
        "assert closure_to_clusters(np.eye(3, dtype=np.uint8), "
        "device='cpu').sum() == 3\n"
        "for fn, args in ((coco_eval.run_coco_eval, (None, root, 'x.json')), "
        "(run2d.render_2d_video, ('x.mp4', 'y.mp4', None))):\n"
        "    try:\n"
        "        fn(*args)\n"
        "        raise AssertionError('read files without cv2')\n"
        "    except ImportError:\n"
        "        pass\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('macaque_tpu', 'jax', 'cv2') and sys.modules[m] is not None]\n"
        "print('eval2d ran', res['det'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "eval2d ran" in proc.stdout
