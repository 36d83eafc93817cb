"""The frame half of the port's synthetic generator against the JAX
package's: the frame-index code, the rendered stores bit for bit, and the
oracle ``SyntheticPerception``'s outputs on the same frames."""

import os

import numpy as np
import pytest
import torch

from macaque_tpu.tools import synthetic as jsyn
from macaque_tpu.video.imgstore import ImgStoreReader as JReader
from macaque_tpu_torch.tools import synthetic as tsyn
from macaque_tpu_torch.video.imgstore import ImgStoreReader


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """4 cameras, 3 animals, 30 frames: the JAX package's FFV1 stores of
    its projections, and the port's projections of the same joints."""
    root = tmp_path_factory.mktemp("synth")
    rig = tsyn.make_test_rig(4)
    kp3d = tsyn.simulate_scene(3, 30, seed=4)
    jproj = jsyn.project_scene(jsyn.make_test_rig(4), kp3d)
    jsyn.render_stores(str(root / "jax"), "s", rig, jproj)
    return rig, kp3d, jproj, tsyn.project_scene(rig, kp3d), root


@pytest.mark.parametrize("idx", [0, 1, 255, 4096, 65535, 12345])
def test_index_code_matches_jax(idx):
    rng = np.random.default_rng(idx)
    a = rng.integers(0, 256, (tsyn.IMG_H, tsyn.IMG_W, 3), dtype=np.uint8)
    b = a.copy()
    tsyn.encode_index(a, idx)
    jsyn.encode_index(b, idx)
    np.testing.assert_array_equal(a, b)
    assert tsyn.decode_index(a) == jsyn.decode_index(a) == idx


def test_projections_match_jax(scene):
    _, _, jproj, proj, _ = scene
    np.testing.assert_allclose(proj, jproj, rtol=0, atol=1e-9)


def test_render_stores_frames_are_the_jax_packages(scene, tmp_path):
    """The port's NumPy boxes are cv2's filled rectangles bit for bit: its
    frames equal the JAX package's FFV1 stores read back, and its own FFV1
    and RGBA stores read back the same."""
    rig, _, jproj, _, root = scene
    tsyn.render_stores(str(tmp_path / "ffv1"), "s", rig, jproj)
    tsyn.render_stores(str(tmp_path / "rgba"), "s", rig, jproj,
                       fourcc="RGBA", chunksize=12)
    for c, cam in enumerate(rig.camera_ids):
        drawn = tsyn.draw_frames(jproj, c)
        want = JReader(str(root / "jax" / f"s.{cam}"))
        stores = [ImgStoreReader(str(tmp_path / f / f"s.{cam}"))
                  for f in ("ffv1", "rgba")]
        for t in range(len(drawn)):
            w = want.get_image(frame_index=t)[0]
            np.testing.assert_array_equal(drawn[t], w)
            for s in stores:
                np.testing.assert_array_equal(s.get_image(frame_index=t)[0], w)


def test_rectangles_match_cv2_off_the_image():
    """Boxes partly or wholly outside the image, thin and empty ones."""
    import cv2

    rng = np.random.default_rng(0)
    pts = np.empty((1, 1, 300, 3, 2))
    for t in range(300):
        x = np.sort(rng.uniform(-300, tsyn.IMG_W + 300, 2))
        y = np.sort(rng.uniform(-300, tsyn.IMG_H + 300, 2))
        if t % 7 == 0:
            x[1] = x[0]
        pts[0, 0, t] = [[x[0], y[0]], [x[1], y[1]], [x[0], y[1]]]
    got = tsyn.draw_frames(pts, 0)
    for t in range(300):
        img = np.full((tsyn.IMG_H, tsyn.IMG_W, 3), 30, np.uint8)
        (x1, y1), (x2, y2) = pts[0, 0, t, 0], pts[0, 0, t, 1]
        cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)),
                      (255, 64, 64), -1)
        tsyn.encode_index(img, t)
        np.testing.assert_array_equal(got[t], img)


@pytest.mark.parametrize("drop_prob", [0.0, 0.3])
def test_synthetic_perception_matches_jax(scene, drop_prob):
    """detect, pose and classify on the same frames and boxes, draw for
    draw from the same generators, for every camera."""
    rig, _, jproj, _, root = scene
    for c, cam in enumerate(rig.camera_ids):
        frames = np.stack([
            JReader(str(root / "jax" / f"s.{cam}")).get_image(
                frame_index=t)[0] for t in (0, 5, 6, 29, 13)])
        p = tsyn.SyntheticPerception(c, jproj, noise=1.0, seed=3,
                                     drop_prob=drop_prob)
        j = jsyn.SyntheticPerception(c, jproj, noise=1.0, seed=3,
                                     drop_prob=drop_prob)
        assert p.id_classes == j.id_classes
        for _ in range(2):
            boxes, scores = p.detect(frames)
            jb, js = j.detect(frames)
            np.testing.assert_array_equal(boxes, jb)
            np.testing.assert_array_equal(scores, js)
            valid = scores > 0
            np.testing.assert_array_equal(p.pose(frames, boxes, valid),
                                          j.pose(frames, boxes, valid))
            for a, b in zip(p.classify(frames, boxes, valid),
                            j.classify(frames, boxes, valid)):
                np.testing.assert_array_equal(a, b)
