"""The port's cage-keypoint labeling tool (``macaque_tpu_torch/calib/
labeler.py``): the five tests of tests/test_labeler.py on the port (state
machine, resume, drawing, headless guard, and rows into
``get_extrinsics_from_cage_keypoints``), each also held against the JAX
package's ``CageLabeler`` on the same clicks: equal rows, equal drawn
images, and the port's ``cam_extrinsic.h5`` equal to the one the JAX
package writes from the same annotations (both are host cv2 PnP)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from macaque_tpu.calib.labeler import CageLabeler as JLabeler  # noqa: E402
from macaque_tpu_torch.calib.labeler import (  # noqa: E402
    CageLabeler, label_cage_keypoints)


def _script(lab):
    """tests/test_labeler.py's clicks and keys."""
    lab.add_point(100, 200)
    lab.next_kp()
    lab.add_point(50, 60)
    lab.prev_kp()
    lab.prev_kp()
    first = lab.current
    for _ in range(10):
        lab.next_kp()
    last = lab.current
    lab.current = 1
    lab.remove_point()
    return first, last


def test_labeler_state_machine():
    kp3d = np.arange(12.0).reshape(4, 3)
    lab = CageLabeler(kp3d)
    assert lab.current == 0 and lab.n_labeled == 0
    lab.add_point(100, 200)
    assert lab.n_labeled == 1
    assert lab.points[0].tolist() == [1, 100, 200]
    assert lab.next_kp() == 1

    lab, jlab = CageLabeler(kp3d), JLabeler(kp3d)
    assert _script(lab) == _script(jlab) == (0, 3)
    assert lab.n_labeled == jlab.n_labeled == 1
    assert lab.points[1, 0] == 0
    rows = lab.rows()
    assert rows.shape == (4, 6)
    np.testing.assert_array_equal(rows[:, 3:], kp3d)
    assert rows[0, :3].tolist() == [1, 100, 200]
    np.testing.assert_array_equal(rows, jlab.rows())


def test_labeler_resume_from_existing():
    kp3d = np.zeros((3, 3))
    prev = np.array([[1, 10, 20, 0, 0, 0],
                     [0, 0, 0, 0, 0, 0],
                     [1, 30, 40, 0, 0, 0]], float)
    lab = CageLabeler(kp3d, initial=prev)
    assert lab.n_labeled == 2
    assert lab.points[2].tolist() == [1, 30, 40]
    np.testing.assert_array_equal(lab.rows(), JLabeler(kp3d,
                                                       initial=prev).rows())


def test_labeler_draw_marks_points():
    img = np.zeros((480, 640, 3), np.uint8)
    outs = []
    for cls in (CageLabeler, JLabeler):
        lab = cls(np.zeros((2, 3)))
        lab.add_point(320, 240)
        lab.next_kp()
        lab.add_point(100, 50)
        outs.append(lab.draw(img))
    out = outs[0]
    assert out.shape == img.shape
    assert (img == 0).all()          # input untouched
    assert out[:, :, 2].sum() > 0    # red marker drawn
    np.testing.assert_array_equal(out, outs[1])


def test_label_cage_keypoints_headless_guard(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="display"):
        label_cage_keypoints(str(tmp_path / "config.yaml"))


def _cage_inputs(root, rig):
    """config.yaml and cam_intrinsic.h5 of tests/test_labeler.py."""
    import h5py
    import yaml

    root.mkdir()
    cfg_path = str(root / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"camera_id": [str(c) for c in rig.camera_ids],
                        "img_size": [640, 480]}, f)
    with h5py.File(str(root / "cam_intrinsic.h5"), "w") as f:
        for i, cid in enumerate(rig.camera_ids):
            g = f.create_group(str(cid))
            g["mtx"] = rig.mtx[i]
            g["dist"] = np.zeros((1, 5))
            g["K"] = rig.K[i]
            g["xi"] = np.array([[rig.xi[i]]])
            g["D"] = rig.D[i].reshape(1, -1)
    return cfg_path


def test_rows_feed_extrinsics_pipeline(tmp_path):
    """Labeler rows -> save_cage_annotations -> PnP extrinsics (reference
    mct:118-242), in the port and in the JAX package from the same clicks."""
    import h5py

    from macaque_tpu.calib import workflow as jwf
    from macaque_tpu_torch.calib import workflow as twf
    from macaque_tpu_torch.tools.synthetic import make_test_rig

    rig = make_test_rig(2, seed=9)
    kp3d = np.array([[x, y, z] for x in (-800, 800.0)
                     for y in (-800, 800.0) for z in (0, 1200.0)])
    outs = {}
    for name, wf, cls in (("jax", jwf, JLabeler), ("port", twf, CageLabeler)):
        cfg_path = _cage_inputs(tmp_path / name, rig)
        data = {}
        for i, cid in enumerate(rig.camera_ids):
            lab = cls(kp3d)
            R, _ = cv2.Rodrigues(rig.rvec[i])
            Xc = kp3d @ R.T + rig.tvec[i]
            uv = (Xc[:, :2] / Xc[:, 2:3]) @ rig.mtx[i][:2, :2].T \
                + rig.mtx[i][:2, 2]
            for j, (u, v) in enumerate(uv):
                lab.current = j
                lab.add_point(float(u), float(v))
            data[str(cid)] = lab.rows()
        wf.save_cage_annotations(cfg_path, data)
        outs[name] = wf.get_extrinsics_from_cage_keypoints(cfg_path,
                                                           verbose=False)
    with h5py.File(outs["port"], "r") as f, h5py.File(outs["jax"], "r") as g:
        assert sorted(f) == sorted(g)
        for i, cid in enumerate(rig.camera_ids):
            rvec = np.asarray(f[f"/{cid}/rvec"]).ravel()
            tvec = np.asarray(f[f"/{cid}/tvec"]).ravel()
            np.testing.assert_allclose(rvec, rig.rvec[i], atol=1e-3)
            np.testing.assert_allclose(tvec, rig.tvec[i], atol=2.0)
            for k in ("rvec", "tvec"):
                np.testing.assert_array_equal(f[f"/{cid}/{k}"][()],
                                              g[f"/{cid}/{k}"][()])
