"""The port is whole: every module of the JAX package has its counterpart
in ``macaque_tpu_torch/``, every public function and class of a JAX module
has its counterpart in the port module (under its own name, or through
``NAMES``) or a reason in ``NAMES_NOT_PORTED``, every function of the JAX
package that reaches ``pl.pallas_call`` has its counterpart that reaches a
hand-written kernel, and every CUDA source of the port is one of those
kernels. A module, a public name or a Pallas kernel added to the JAX
package without its counterpart, or a ``csrc/*.cu`` added without its row
here, fails this file.

The sources are read with ``ast`` and ``os.walk``; neither package is
imported. That each wrapper launches through ``kernels.launch`` under its
input's device is held by tests/test_torch_mesh.py; that each kernel
agrees with its plain version, by tests/test_torch_cuda.py on the card and
by ``chip_smoke.py``."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "macaque_tpu")
PORT = os.path.join(ROOT, "macaque_tpu_torch")
CSRC = os.path.join(PORT, "csrc")

# the JAX modules whose counterpart has another path
RENAMED = {
    "nn/pallas_attention.py": "nn/attention.py",
    "nn/pallas_int8.py": "nn/int8.py",
    "nn/pallas_roialign.py": "nn/roialign.py",
    "nn/pallas_swin_block.py": "nn/swin_block.py",
}
# the JAX modules with no counterpart, and why
NOT_PORTED = {
    "core/compile_cache.py": (
        "JAX's persistent XLA compile cache; the port's counterpart is the "
        "kernel library's _build/, built once and keyed by a hash of the "
        "CUDA sources (kernels.py), and its perf_tables keeps its own "
        "repo_root"),
}

# the public names of the JAX package whose counterpart has another name or
# lives in another port module: (JAX module, name) -> (port module, name)
NAMES = {
    ("core/trace.py", "xla_profile"): ("core/trace.py", "torch_profile"),
    ("nn/ops.py", "roi_align_windowed"): ("nn/roialign.py",
                                          "roi_align_windowed"),
    ("nn/pallas_attention.py", "fused_attention_packed"):
        ("nn/attention.py", "packed_attention"),
    ("nn/pallas_attention.py", "fused_window_attention"):
        ("nn/attention.py", "window_attention"),
    ("nn/pallas_attention.py", "fused_window_attention_blocked"):
        ("nn/attention.py", "window_attention"),
    ("nn/pallas_roialign.py", "roi_align_windowed_fused"):
        ("nn/roialign.py", "roi_align_windowed"),
    ("nn/pallas_roialign.py", "roi_align_windowed_switch"):
        ("nn/roialign.py", "roi_align_windowed"),
    ("nn/quant.py", "Int8Dense"): ("nn/quant.py", "Int8Linear"),
    ("nn/quant.py", "int8_matmul"): ("nn/quant.py", "int8_matmul_reference"),
    ("nn/quant.py", "quantize_swin_params"): ("nn/quant.py", "quantize_swin_"),
    ("nn/quant.py", "quantize_vitpose_params"):
        ("nn/quant.py", "quantize_vitpose_"),
    ("nn/swin.py", "WindowAttention"): ("nn/swin.py", "WindowMSA"),
    ("pipeline/perception.py", "FlaxPerception"):
        ("pipeline/perception.py", "TorchPerception"),
    ("pipeline/weights.py", "build_flax_perception"):
        ("pipeline/weights.py", "build_torch_perception"),
    ("tracking/hungarian.py", "hungarian_jax"):
        ("tracking/hungarian.py", "hungarian_torch"),
    ("tracking/kalman.py", "kalman_predict_jax"):
        ("tracking/kalman.py", "kalman_predict"),
    ("tracking/kalman.py", "kalman_update_jax"):
        ("tracking/kalman.py", "kalman_update"),
}
_CONVERT = ("turns an mm-keyed PyTorch state dict into a Flax tree; the port's "
            "modules keep the mm key names and load such a state dict as it "
            "is (pipeline/weights.py::load_checkpoint)")
# the public names of the JAX package with no counterpart, and why
NAMES_NOT_PORTED = {
    ("nn/pallas_swin_block.py", "pad_window_bias"): (
        "pads the Pallas kernel's bias to its TPU tile; the port's fused block "
        "takes the unpadded bias (nn/swin_block.py::block_inputs)"),
    ("nn/pallas_swin_block.py", "pad_window_mask"): (
        "pads the Pallas kernel's shift mask to its TPU tile; the port's fused "
        "block takes the unpadded mask (nn/swin_block.py::block_inputs)"),
    ("nn/convert.py", "convert_vitpose"): _CONVERT,
    ("nn/convert.py", "convert_resnet"): _CONVERT,
    ("nn/convert.py", "convert_swin_backbone"): _CONVERT,
    ("nn/convert.py", "convert_swin_maskrcnn"): _CONVERT,
    ("nn/convert.py", "load_torch_checkpoint"): (
        "reads a .pth for the Flax converters; the port reads it with "
        "torch.load in pipeline/weights.py::load_checkpoint"),
}

# each hand-written kernel: its CUDA source, the port module that holds its
# wrapper, the wrapper that launches it, the launch counter it adds to (the
# ``kernels.launch`` call's first argument) and its plain version beside it
KERNELS = {
    "K1": ("packed_attention.cu", "nn/attention.py", "packed_attention",
           "packed_attention", "packed_attention_reference"),
    "K2": ("roi_align_windowed.cu", "nn/roialign.py", "roi_align_windows",
           "roi_align_windowed", "roi_align_windows_reference"),
    "K3": ("window_attention.cu", "nn/attention.py", "window_attention",
           "window_attention", "window_attention_reference"),
    "K4": ("attention.cu", "nn/attention.py", "_unpacked_attention",
           "attention", "attention_reference"),
    "K5a": ("quantize_rows.cu", "nn/int8.py", "quantize_rows",
            "quantize_rows", "quantize_rows_reference"),
    "K5b": ("int8_matmul.cu", "nn/int8.py", "quant_int8_matmul",
            "quant_int8_matmul", "quant_int8_matmul_reference"),
    "K6": ("swin_block.cu", "nn/swin_block.py", "fused_swin_block",
           "swin_block", "fused_swin_block_reference"),
    "K7": ("relpos_attention.cu", "nn/attention.py", "relpos_attention",
           "relpos_attention", "relpos_attention_reference"),
}

# kernels of networks the JAX package does not have, so no Pallas function
# reaches them: each with its reason
PORT_ONLY = {
    "K7": "ViTDet-H's attention with decomposed relative position; the JAX "
          "package has no ViTDet",
}

# each JAX function that reaches ``pl.pallas_call`` (in its body, or through
# a function of its module that does): its counterpart in the port module of
# the same role, and the kernel that counterpart reaches
PALLAS = {
    ("nn/pallas_attention.py", "fused_attention_packed"):
        ("packed_attention", "K1"),
    ("nn/pallas_roialign.py", "roi_align_windowed_fused"):
        ("roi_align_windowed", "K2"),
    ("nn/pallas_roialign.py", "roi_align_windowed_switch"):
        ("roi_align_windowed", "K2"),
    ("nn/pallas_attention.py", "fused_window_attention"):
        ("window_attention", "K3"),
    ("nn/pallas_attention.py", "fused_window_attention_blocked"):
        ("window_attention", "K3"),
    ("nn/pallas_attention.py", "fused_attention"): ("fused_attention", "K4"),
    ("nn/pallas_attention.py", "fused_attention_blocked"):
        ("fused_attention_blocked", "K4"),
    ("nn/pallas_attention.py", "attention"): ("attention", "K4"),
    ("nn/pallas_int8.py", "quantize_rows"): ("quantize_rows", "K5a"),
    ("nn/pallas_int8.py", "quant_int8_matmul_split"):
        ("quant_int8_matmul_split", "K5a"),
    ("nn/pallas_int8.py", "quant_int8_matmul"): ("quant_int8_matmul", "K5b"),
    ("nn/pallas_swin_block.py", "fused_swin_block"):
        ("fused_swin_block", "K6"),
    ("nn/pallas_swin_block.py", "swin_backbone_apply_fused"):
        ("swin_backbone_apply_fused", "K6"),
}


def modules(pkg):
    """Every ``.py`` file under ``pkg``, as a path relative to it."""
    out = set()
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                out.add(os.path.relpath(os.path.join(root, f), pkg)
                        .replace(os.sep, "/"))
    return out


def functions(path):
    """The module-level functions of ``path`` by name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def public(path):
    """The public top-level functions and classes of ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def bound(path):
    """Every name bound at the top level of ``path``: a function or class
    defined there, an assignment, or an import."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in n.names}
    return out


def names(fn):
    """Every name that ``fn`` reads (a call, or a function handed on, as to
    ``functools.partial``)."""
    return {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}


def reaching(funcs, start):
    """The functions of ``funcs`` that are in ``start`` or read one that
    reaches it."""
    out = set(start)
    grew = True
    while grew:
        grew = False
        for k, fn in funcs.items():
            if k not in out and names(fn) & out:
                out.add(k)
                grew = True
    return out


def pallas_functions():
    """(module, function) of every JAX function that reaches
    ``pl.pallas_call``."""
    out = set()
    for rel in sorted(modules(JAX)):
        funcs = functions(os.path.join(JAX, rel))
        direct = {k for k, fn in funcs.items() if any(
            isinstance(n, ast.Attribute) and n.attr == "pallas_call"
            for n in ast.walk(fn))}
        out |= {(rel, k) for k in reaching(funcs, direct)}
    return out


def launches(fn):
    """The counters of the ``kernels.launch(...)`` calls in ``fn``."""
    return {n.args[0].value for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "launch"
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "kernels"
            and n.args and isinstance(n.args[0], ast.Constant)}


def counterpart(rel):
    return RENAMED.get(rel, rel)


def test_every_module_has_its_counterpart():
    missing = sorted(rel for rel in modules(JAX) - set(NOT_PORTED)
                     if not os.path.isfile(os.path.join(PORT, counterpart(rel))))
    assert not missing, f"JAX modules with no port counterpart: {missing}"


def test_the_module_maps_name_files_that_exist():
    jax = modules(JAX)
    for rel, port in RENAMED.items():
        assert rel in jax, f"{rel} is no longer a JAX module"
        assert os.path.isfile(os.path.join(PORT, port)), port
        assert not os.path.exists(os.path.join(PORT, rel)), rel
    for rel, why in NOT_PORTED.items():
        assert rel in jax and why
        assert not os.path.exists(os.path.join(PORT, rel)), rel


def test_every_pallas_function_is_in_the_map():
    got = pallas_functions()
    assert got - set(PALLAS) == set(), "Pallas functions with no port row"
    assert set(PALLAS) - got == set(), "rows of no Pallas function"


@pytest.mark.parametrize("rel", sorted(modules(JAX) - set(NOT_PORTED)))
def test_every_public_name_has_its_counterpart(rel):
    here = bound(os.path.join(PORT, counterpart(rel)))
    missing = sorted(
        name for name in public(os.path.join(JAX, rel))
        if name not in here and (rel, name) not in NAMES
        and (rel, name) not in NAMES_NOT_PORTED)
    assert not missing, f"{rel}: public names with no counterpart in " \
        f"{counterpart(rel)} and no row in NAMES or NAMES_NOT_PORTED: {missing}"


def test_the_name_maps_name_what_exists():
    assert not set(NAMES) & set(NAMES_NOT_PORTED)
    for (rel, name), (port, port_name) in NAMES.items():
        assert name in public(os.path.join(JAX, rel)), (rel, name)
        assert port_name in bound(os.path.join(PORT, port)), (port, port_name)
    for (rel, name), why in NAMES_NOT_PORTED.items():
        assert name in public(os.path.join(JAX, rel)) and why, (rel, name)
        assert name not in bound(os.path.join(PORT, counterpart(rel))), \
            f"{rel}::{name} is ported; take it out of NAMES_NOT_PORTED"


@pytest.mark.parametrize("key", sorted(PALLAS), ids="::".join)
def test_each_pallas_function_reaches_its_kernel_in_the_port(key):
    rel, _ = key
    port_fn, kernel = PALLAS[key]
    _, module, wrapper, _, _ = KERNELS[kernel]
    assert counterpart(rel) == module, (rel, module)
    funcs = functions(os.path.join(PORT, module))
    assert port_fn in funcs, f"{module} has no {port_fn}"
    assert port_fn in reaching(funcs, {wrapper}), \
        f"{module}::{port_fn} does not reach {wrapper}"


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_each_kernel_has_its_source_wrapper_counter_and_plain_version(kernel):
    cu, module, wrapper, counter, reference = KERNELS[kernel]
    assert os.path.isfile(os.path.join(CSRC, cu)), cu
    funcs = functions(os.path.join(PORT, module))
    assert wrapper in funcs and reference in funcs, (module, wrapper, reference)
    assert launches(funcs[wrapper]) == {counter}, (module, wrapper)
    others = [k for k, fn in funcs.items()
              if k != wrapper and counter in launches(fn)]
    assert not others, f"{counter} is launched outside {wrapper}: {others}"


def launch_counters():
    """The keys of ``kernels.LAUNCHES``."""
    with open(os.path.join(PORT, "kernels.py")) as f:
        tree = ast.parse(f.read())
    return set(next(ast.literal_eval(n.value) for n in tree.body
                    if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == "LAUNCHES"))


def test_every_cuda_source_is_a_kernel_of_the_map():
    sources = {f for f in os.listdir(CSRC) if f.endswith(".cu")}
    mapped = {row[0] for row in KERNELS.values()}
    assert sources == mapped, (sorted(sources - mapped),
                               sorted(mapped - sources))
    assert launch_counters() == {row[3] for row in KERNELS.values()}
    assert {row[1] for row in PALLAS.values()} == set(KERNELS) - set(PORT_ONLY)
    assert set(PORT_ONLY) <= set(KERNELS) and all(PORT_ONLY.values())
