"""The port's ``tools/perf_tables.py`` against the JAX package's on
benchmark lines built here: the README and architecture blocks, and the
rewrite between markers, must be equal after exactly the departures that
the port's docstring lists (the device in the header and the paragraph,
the tool's name, its markers, its pointers into PERF.md). Then what only
the port does: it refuses a line that names no card, a TPU-shaped
artifact, and a default search that finds no card's line, and its
``main()`` rewrites only the ``TORCH_BENCH`` blocks of README.md and
PERF.md.

The JAX tool's ``main()`` is never called here: it rewrites the
repository's own README.md and ARCHITECTURE.md. Every file the port's
``main()`` touches is a temporary copy, under a ``repo_root`` pointed at a
temporary directory; no test reads the repository's ``BENCH_*.json``."""

import copy
import json
import os
import shutil

import pytest

from macaque_tpu.tools import perf_tables as jpt
from macaque_tpu_torch.tools import perf_tables as tpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
ADDITIVE = ("value = parity-semantics additive e2e; serving/fast tiers in "
            "detail (see ARCHITECTURE.md 3b)")
PARITY = "value = measured PARITY e2e on a locally-attached device; tiers"


def _full(note=ADDITIVE, device=CARD):
    """A bench.py-shaped line with all four tiers and ``pipeline``, the
    card named where pipeline_bench puts it."""
    return {
        "metric": "e2e_camera_frames_per_sec_per_chip", "value": 30.58,
        "unit": "camera-frames/s", "vs_baseline": 4.78,
        "detail": {
            "kernel_cf_s": 44.12,
            "kernel_ms_per_chunk": {"det": 152.3, "pose": 196.1, "id": 12.6,
                                    "tri": 1.6},
            "det_fast_ms": 120.9, "pose_int8_ms": 150.7,
            "kernel_cf_s_int8": 50.44, "kernel_cf_s_serving": 55.99,
            "det_640_ms": 77.3, "pose_noflip_int8_ms": 76.0,
            "kernel_cf_s_fast": 95.53,
            "pipeline": {
                "camera_frames": 480,
                "stages_s": {"step1_host": 1.768, "step2_crossview": 0.125,
                             "step3_crossframe": 0.216, "step4_3d": 0.527,
                             "render": 2.183},
                "pipeline_rest_s": 4.819, "pipeline_rest_s_per_cf": 0.01004,
                "pipeline_cf_s": 99.6, "device_round_trip_s": 0.031,
                "device": device},
            "tier_note": note}}


def _no_tiers():
    p = _full()
    for k in ("kernel_cf_s", "kernel_cf_s_int8", "kernel_cf_s_serving",
              "kernel_cf_s_fast", "det_fast_ms", "det_640_ms",
              "pose_int8_ms", "pose_noflip_int8_ms"):
        del p["detail"][k]
    return p


def _no_pipeline():
    """Without ``pipeline``, so the card is named in ``detail``."""
    p = _full()
    del p["detail"]["pipeline"]
    p["detail"]["device"] = CARD
    return p


def _tri_below_1ms():
    """Without ``render`` in the stages, the card named at the top."""
    p = _full(note="kernel-only")
    p["detail"]["kernel_ms_per_chunk"]["tri"] = 0.4
    del p["detail"]["pipeline"]["stages_s"]["render"]
    del p["detail"]["pipeline"]["device"]
    p["device"] = CARD
    return p


LINES = {
    "full-additive": _full,
    "full-parity": lambda: _full(note=PARITY),
    "no-tiers": _no_tiers,
    "no-pipeline": _no_pipeline,
    "tri-below-1ms": _tri_below_1ms,
}


def as_port(text):
    """The JAX tool's text with the port's departures, and no other."""
    return (text.replace("generated by tools/perf_tables.py",
                         "generated by macaque_tpu_torch/tools/perf_tables.py")
            .replace("(1x v5e)", f"(1x {CARD})")
            .replace("Bench (real", f"Bench on {CARD} (real")
            .replace("ARCHITECTURE.md §3b", "PERF.md §1 and §6")
            .replace("Tier semantics in §3b.", "Tier semantics in PERF.md §1."))


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("name", list(LINES))
def test_blocks_equal_the_jax_tools(tmp_path, name, wrapped):
    line = LINES[name]()
    obj = {"rc": 0, "parsed": line} if wrapped else line
    path = _write(tmp_path / f"{name}.json", obj)
    got, want = tpt.load_bench(path), jpt.load_bench(path)
    assert got == want == (line, f"{name}.json")
    for port, jax in ((tpt.readme_block, jpt.readme_block),
                      (tpt.arch_block, jpt.arch_block)):
        j = jax(copy.deepcopy(line), got[1])
        assert as_port(j) != j
        assert port(line, got[1]) == as_port(j)
    readme = tpt.readme_block(line, got[1])
    assert f"| tier (semantics) | camera-frames/s (1x {CARD}) |" in readme
    assert ("triangulation <1 ms." in readme) == (name == "tri-below-1ms")


@pytest.mark.parametrize("name", ["full-additive", "no-pipeline"])
def test_rewrite_equals_the_jax_tools(tmp_path, name, capsys):
    line = LINES[name]()
    bodies = {}
    for pkg, tool, marker in (("jax", jpt, "BENCH"),
                              ("port", tpt, "TORCH_BENCH")):
        path = tmp_path / f"{pkg}.md"
        path.write_text(f"# Title\n\nhand-written\n<!-- {marker}:START -->\n"
                        f"old table\nold line\n<!-- {marker}:END -->\ntail\n")
        block = tool.arch_block(line, "line.json")
        assert tool.rewrite(str(path), block) is True
        assert tool.rewrite(str(path), block) is False        # current
        bodies[pkg] = path.read_text()
    assert bodies["port"] == as_port(bodies["jax"]).replace(
        "<!-- BENCH:", "<!-- TORCH_BENCH:")
    assert "old table" not in bodies["port"]
    assert capsys.readouterr().err == ""


def test_rewrite_without_markers_says_so_in_both(tmp_path, capsys):
    errs = {}
    for pkg, tool in (("jax", jpt), ("port", tpt)):
        path = tmp_path / f"{pkg}.md"
        # the other tool's markers are not this tool's
        path.write_text("text\n<!-- BENCH:START -->\nx\n<!-- BENCH:END -->\n"
                        if pkg == "port" else "text\n")
        before = path.read_text()
        assert tool.rewrite(str(path), "block") is False
        assert path.read_text() == before
        errs[pkg] = capsys.readouterr().err.replace(str(path), "PATH")
    assert errs["jax"] == "PATH: no BENCH markers found\n"
    assert errs["port"] == errs["jax"].replace("no BENCH", "no TORCH_BENCH")


@pytest.mark.parametrize("where", ["none", "cpu", "cpu:0", "empty"])
def test_a_line_that_names_no_card_is_refused(tmp_path, where):
    line = _full(device={"none": None, "cpu": "cpu", "cpu:0": "cpu:0",
                         "empty": ""}[where])
    if where == "none":
        del line["detail"]["pipeline"]["device"]
    path = _write(tmp_path / "line.json", {"rc": 0, "parsed": line})
    for fn in (lambda: tpt.load_bench(path),
               lambda: tpt.readme_block(line, "line.json"),
               lambda: tpt.arch_block(line, "line.json")):
        with pytest.raises(SystemExit, match="names no card"):
            fn()
    # the JAX tool renders the same line, as a TPU line
    assert "(1x v5e)" in jpt.readme_block(line, "line.json")


def _tpu_artifact():
    """Shaped like the BENCH_r*.json TPU artifacts: a tail and a parsed line
    with no device."""
    line = _full()
    del line["detail"]["pipeline"]["device"]
    return {"n": 5, "cmd": "python bench.py", "rc": 0,
            "tail": json.dumps(line) + "\n", "parsed": line}


def _fake_root(tmp_path, monkeypatch):
    """Copies of README.md and PERF.md under a temporary ``repo_root``."""
    root = tmp_path / "root"
    root.mkdir()
    for f in ("README.md", "PERF.md"):
        shutil.copy(os.path.join(ROOT, f), root / f)
    monkeypatch.setattr(tpt, "repo_root", lambda: str(root))
    return root


def _texts(root):
    return {f: (root / f).read_text() for f in ("README.md", "PERF.md")}


def test_bench_flag_refuses_a_tpu_artifact(tmp_path, monkeypatch):
    root = _fake_root(tmp_path, monkeypatch)
    before = _texts(root)
    path = _write(tmp_path / "BENCH_r05.json", _tpu_artifact())
    with pytest.raises(SystemExit, match="BENCH_r05.json: the line names no "
                                         "card"):
        tpt.main(["--bench", path])
    assert _texts(root) == before


def test_default_search_takes_the_newest_card_line(tmp_path, monkeypatch,
                                                   capsys):
    root = _fake_root(tmp_path, monkeypatch)
    before = _texts(root)
    _write(root / "BENCH_r01.json", _tpu_artifact())
    _write(root / "BENCH_r02.json", {"rc": 1, "parsed": None})
    with pytest.raises(SystemExit, match="no BENCH_r.*on the card"):
        tpt.main([])
    assert _texts(root) == before
    _write(root / "BENCH_r03.json", {"rc": 0, "parsed": _full()})
    _write(root / "BENCH_r04.json", _tpu_artifact())
    assert tpt.load_bench(None) == (_full(), "BENCH_r03.json")
    tpt.main([])
    assert capsys.readouterr().out == (
        "README.md: updated (from BENCH_r03.json)\n"
        "PERF.md: updated (from BENCH_r03.json)\n")


def _split(text, marker):
    start, end = f"<!-- {marker}:START -->\n", f"\n<!-- {marker}:END -->"
    assert text.count(start) == 1 and text.count(end) == 1
    head, rest = text.split(start)
    body, tail = rest.split(end)
    return head, body, tail


def test_main_rewrites_only_the_torch_bench_blocks(tmp_path, monkeypatch,
                                                  capsys):
    """README.md and PERF.md each hold one ``TORCH_BENCH`` pair (README
    also the JAX tool's ``BENCH`` pair, which stays as it was); a second
    call finds them current."""
    root = _fake_root(tmp_path, monkeypatch)
    before = _texts(root)
    path = _write(tmp_path / "line.json", _full())
    tpt.main(["--bench", path])
    after = _texts(root)
    line = _full()
    for f, make in (("README.md", tpt.readme_block),
                    ("PERF.md", tpt.arch_block)):
        h0, _, t0 = _split(before[f], "TORCH_BENCH")
        h1, body, t1 = _split(after[f], "TORCH_BENCH")
        assert (h1, t1) == (h0, t0)
        assert body == make(line, "line.json") and CARD in body
    assert (_split(after["README.md"], "BENCH")[1]
            == _split(before["README.md"], "BENCH")[1])
    assert "<!-- BENCH:START -->" not in after["PERF.md"]
    capsys.readouterr()
    tpt.main(["--bench", path])
    assert capsys.readouterr().out == (
        "README.md: already current (from line.json)\n"
        "PERF.md: already current (from line.json)\n")
