"""The port's imgstore reader and writer against the JAX package's.

Held: the port's ``metadata.yaml`` reader (``utils/yamlmeta.py``) equals
``yaml.safe_load`` on the JAX writer's files and on a sample shaped like
the reference's production file, and its writer writes the bytes of
``yaml.safe_dump``; RGBA stores written by either package read frame for
frame through the other (the port with cv2 and PyYAML blocked); frame
metadata and random access by frame number agree; cv2 flavours still read
through cv2."""

import os
import random
import string
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from macaque_tpu.video.imgstore import ImgStoreReader as JReader
from macaque_tpu.video.imgstore import write_imgstore as jwrite
from macaque_tpu_torch.utils import yamlmeta
from macaque_tpu_torch.video.avi import RgbaAviReader, write_rgba_avi
from macaque_tpu_torch.video.imgstore import ImgStoreReader, write_imgstore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fourcc, extension the JAX writer is given (its rule picks .mp4 for RGBA)
FLAVOURS = {"FFV1": None, "mp4v": None, "RGBA": ".avi"}

PRODUCTION = """\
__store:
  chunksize: 10000
  class: VideoImgStoreFFMPEG
  created_utc: '2021-09-14T01:02:03.456789+00:00'
  encoding: bgr24
  extension: .mp4
  format: h264_nvenc/mp4
  framerate: 24.0
  imgshape:
  - 1536
  - 2048
  - 3
  imgtype: uint8
  roi: [[0, 0], [2048, 1536]]
  timezone_local: Asia/Tokyo
  uuid: 3f2a9c1e8b7d4e6f
  version: 3
user:
  camera_serial: '22972495'
  exposure_us: 8000.0   # Basler acA2040-35gc
  gain: -1.5
  ptp:
    enabled: true
    offsets_ns:
    - - 0
      - 12
    - [3, -4]
  motif: {version: "5.2.1", recorder: null, flags: [on, off, ~]}
  notes: "cage 2, \\"north\\" wall"
  count: 0x1F
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


# --------------------------------------------------------- metadata.yaml


@pytest.mark.parametrize("fourcc", list(FLAVOURS))
def test_metadata_reader_equals_safe_load_on_the_jax_writers_file(tmp_path,
                                                                 fourcc):
    path = jwrite(str(tmp_path / "j"), _frames(3), chunksize=2, fourcc=fourcc,
                  ext=FLAVOURS[fourcc])
    with open(os.path.join(path, "metadata.yaml")) as f:
        text = f.read()
    assert yamlmeta.load(text) == yaml.safe_load(text)
    assert ImgStoreReader(path).metadata == JReader(path).metadata


@pytest.mark.parametrize("fourcc", list(FLAVOURS))
def test_metadata_writer_is_byte_equal_to_safe_dump(tmp_path, fourcc):
    ext = FLAVOURS[fourcc]
    for pkg, write in (("port", write_imgstore), ("jax", jwrite)):
        write(str(tmp_path / pkg), _frames(3), fps=29.97, chunksize=2,
              fourcc=fourcc, ext=ext)
    with open(tmp_path / "port" / "metadata.yaml", "rb") as a, \
            open(tmp_path / "jax" / "metadata.yaml", "rb") as b:
        assert a.read() == b.read()


def test_metadata_reader_on_a_production_shaped_file():
    want = yaml.safe_load(PRODUCTION)
    got = yamlmeta.load(PRODUCTION)
    assert got == want
    assert got["user"]["ptp"]["offsets_ns"] == [[0, 12], [3, -4]]


def _random_doc(rng):
    specials = ["", "a,b", "a: b", "a:b", "-a", "- a", "-", "?a", "#a",
                "a #b", "it's", "1.0", "1", "0x1f", "yes", "No", "null", "~",
                "2021-01-01", "1:20", ".inf", "1e5", "=", "avi/RGBA",
                "h264_nvenc/mp4", "017", "True", "a[b]", "{a}", " a", "a "]

    def scalar():
        r = rng.random()
        if r < 0.3:
            return rng.choice(specials)
        if r < 0.4:
            return rng.randint(-10 ** 6, 10 ** 6)
        if r < 0.5:
            return rng.choice([0.0, -1.5, 24.0, 1e20, 1.5e-7, float("inf")])
        if r < 0.55:
            return rng.choice([None, True, False])
        return "".join(rng.choice(string.ascii_letters + " _-./:,#'\"[]{}?!")
                       for _ in range(rng.randint(1, 12)))

    def node(depth):
        r = rng.random()
        if depth > 3 or r < 0.4:
            return scalar()
        if r < 0.7:
            return {(str(scalar()) or "k"): node(depth + 1)
                    for _ in range(rng.randint(0, 4))}
        return [node(depth + 1) for _ in range(rng.randint(0, 4))]

    return {f"k{i}": node(0) for i in range(rng.randint(1, 4))}


@pytest.mark.parametrize("seed", range(4))
def test_yamlmeta_against_pyyaml_on_random_documents(seed):
    """Dump byte-equal to ``yaml.safe_dump`` and load equal to
    ``yaml.safe_load``, on 300 random documents of the covered subset."""
    rng = random.Random(seed)
    n = 0
    while n < 300:
        doc = _random_doc(rng)
        want = yaml.safe_dump(doc)
        if max(map(len, want.splitlines())) > 78:    # PyYAML folds those
            continue
        assert yamlmeta.dump(doc) == want, doc
        assert repr(yamlmeta.load(want)) == repr(yaml.safe_load(want))
        n += 1


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: |\n  text\n",
                                  "a: !!str 1\n", "a: 1\n  b: 2\n"])
def test_yamlmeta_refuses_what_it_does_not_cover(text):
    with pytest.raises(ValueError):
        yamlmeta.load(text)


# ----------------------------------------------------------- RGBA stores


def test_jax_reader_reads_a_port_written_multi_chunk_rgba_store(tmp_path):
    frames = _frames(25)
    path = write_imgstore(str(tmp_path / "s"), frames, chunksize=10,
                          fourcc="RGBA")
    assert sorted(f for f in os.listdir(path) if f.endswith(".avi")) == [
        "000000.avi", "000001.avi", "000002.avi"]
    r = JReader(path)
    for i in list(range(25)) + [3, 17, 0, 24]:
        img, (fn, _) = r.get_image(frame_index=i)
        assert fn == i
        np.testing.assert_array_equal(img, frames[i])
    r.close()


def test_port_reads_a_jax_written_rgba_store_without_cv2_or_yaml(tmp_path):
    frames = _frames(25, seed=1)
    jwrite(str(tmp_path / "s"), frames, chunksize=10, fourcc="RGBA",
           ext=".avi")
    np.save(tmp_path / "frames.npy", frames)
    code = (
        "import sys\n"
        "for m in ('cv2', 'yaml', 'jax', 'macaque_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from macaque_tpu_torch.video.imgstore import ImgStoreReader\n"
        f"want = np.load({str(tmp_path / 'frames.npy')!r})\n"
        f"r = ImgStoreReader({str(tmp_path / 's')!r})\n"
        "assert len(r) == len(want)\n"
        "for i in list(range(len(want))) + [24, 3, 11]:\n"
        "    img, (fn, ft) = r.get_image(frame_index=i)\n"
        "    assert fn == i and img.flags['C_CONTIGUOUS']\n"
        "    assert np.array_equal(img, want[i]), i\n"
        "r.close()\n"
        "print('read', len(want))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "read 25" in proc.stdout


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_frame_metadata_and_random_access_by_frame_number(tmp_path, writer):
    frames = _frames(12, seed=2)
    fnums = np.arange(100, 112)
    write = write_imgstore if writer == "port" else jwrite
    path = write(str(tmp_path / "s"), frames, fps=24.0, chunksize=5,
                 frame_numbers=fnums, fourcc="RGBA", ext=".avi")
    p, j = ImgStoreReader(path), JReader(path)
    for k in ("frame_number", "frame_time"):
        np.testing.assert_array_equal(p.get_frame_metadata()[k],
                                      j.get_frame_metadata()[k])
    assert (len(p), p.frame_min, p.frame_max) == (len(j), j.frame_min,
                                                  j.frame_max)
    for fn in (105, 100, 111, 109, 104):
        a, ma = p.get_image(frame_number=fn)
        b, mb = j.get_image(frame_number=fn)
        assert ma == mb
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, frames[fn - 100])
    a, ma = p.get_next_image()
    b, mb = j.get_next_image()
    assert ma == mb == (105, 105 / 24)
    np.testing.assert_array_equal(a, b)
    a, ma = p.get_nearest_image(0.3)
    b, mb = j.get_nearest_image(0.3)
    assert ma == mb
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fourcc", ["FFV1", "mp4v"])
def test_cv2_flavours_still_read_equal_through_cv2(tmp_path, fourcc):
    frames = _frames(15, seed=3)
    path = jwrite(str(tmp_path / "s"), frames, chunksize=6, fourcc=fourcc)
    p, j = ImgStoreReader(path), JReader(path)
    for i in (0, 5, 6, 14, 2, 7):
        np.testing.assert_array_equal(p.get_image(frame_index=i)[0],
                                      j.get_image(frame_index=i)[0])
    if fourcc == "FFV1":
        np.testing.assert_array_equal(p.get_image(frame_index=9)[0],
                                      frames[9])


def test_avi_reader_walks_cv2s_file_and_writer_round_trips(tmp_path):
    """cv2's RGBA file carries a ``00dc`` tag inside its OpenDML index
    placeholder in ``hdrl``: the reader finds the frames by the RIFF tree
    alone. The port's file reads back through cv2 at a non-integer rate."""
    import cv2

    frames = _frames(4, 30, 40, seed=4)
    vw = cv2.VideoWriter(str(tmp_path / "c.avi"),
                         cv2.VideoWriter_fourcc(*"RGBA"), 24.0, (40, 30))
    for f in frames:
        vw.write(f)
    vw.release()
    with open(tmp_path / "c.avi", "rb") as f:
        raw = f.read()
    assert raw.count(b"00dc") > len(frames)
    r = RgbaAviReader(str(tmp_path / "c.avi"))
    assert len(r) == 4 and (r.width, r.height) == (40, 30)
    for i in (3, 0, 2, 1):
        np.testing.assert_array_equal(r.read(i), frames[i])
    r.release()
    write_rgba_avi(str(tmp_path / "p.avi"), frames, 29.97)
    cap = cv2.VideoCapture(str(tmp_path / "p.avi"))
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 29.97) < 1e-6
    for f in frames:
        ok, img = cap.read()
        assert ok
        np.testing.assert_array_equal(img, f)
    cap.release()


def test_rgba_writer_refuses_a_chunk_past_1_gib(tmp_path):
    big = np.broadcast_to(np.zeros((1, 1, 1, 3), np.uint8),
                          (100, 1536, 2048, 3))
    with pytest.raises(ValueError, match="chunksize"):
        write_imgstore(str(tmp_path / "big"), big, fourcc="RGBA")
    assert not os.path.exists(tmp_path / "big" / "000000.avi")
    with pytest.raises(ValueError, match=".avi"):
        write_imgstore(str(tmp_path / "mp4"), _frames(2), fourcc="RGBA",
                       ext=".mp4")


def test_avi_reader_refuses_another_codec(tmp_path):
    path = jwrite(str(tmp_path / "s"), _frames(2), fourcc="FFV1")
    with pytest.raises(ValueError, match="RGBA"):
        RgbaAviReader(os.path.join(path, "000000.avi"))
