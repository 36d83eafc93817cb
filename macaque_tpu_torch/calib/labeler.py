"""Interactive cage-keypoint labeling (reference mct:118-211
``label_cagekeypoints``).

For each camera, the operator clicks the 2D image position of every
known 3D cage keypoint on a 640x480 display frame; rows of
``[flag, x, y, X, Y, Z]`` go to ``cagepoints_annotation.h5`` via
:func:`macaque_tpu_torch.calib.workflow.save_cage_annotations` (same
file protocol, consumed by ``get_extrinsics_from_cage_keypoints``).

The labeling state machine (:class:`CageLabeler`) is separated from the
cv2 window loop so it is unit-testable headless and drivable by any UI;
``run_gui`` provides the reference's keybindings:

  left click   label current keypoint at the cursor
  middle click unlabel current keypoint
  W / S        next / previous keypoint
  A / D        step video back (-10) / forward (+1) frames
  space        finish this camera, move to the next

Port of ``macaque_tpu/calib/labeler.py``, the same host code; ``cv2``,
``yaml`` and ``h5py`` are imported by the functions that use them.
"""

from __future__ import annotations

import glob
import os

import numpy as np

DISPLAY_W, DISPLAY_H = 640, 480


class CageLabeler:
    """Per-camera labeling state: current keypoint index + (n_kp, 3)
    rows of [flag, x, y] in display coordinates."""

    def __init__(self, kp3d: np.ndarray, initial: np.ndarray | None = None):
        self.kp3d = np.asarray(kp3d, float)          # (n_kp, 3) world mm
        self.n_kp = self.kp3d.shape[0]
        self.current = 0
        if initial is not None and initial.shape[0] == self.n_kp:
            self.points = np.asarray(initial[:, :3], float).copy()
        else:
            self.points = np.zeros((self.n_kp, 3))

    def add_point(self, x: float, y: float) -> None:
        self.points[self.current] = [1, x, y]

    def remove_point(self) -> None:
        self.points[self.current, 0] = 0

    def next_kp(self) -> int:
        self.current = min(self.n_kp - 1, self.current + 1)
        return self.current

    def prev_kp(self) -> int:
        self.current = max(0, self.current - 1)
        return self.current

    @property
    def n_labeled(self) -> int:
        return int((self.points[:, 0] > 0).sum())

    def rows(self) -> np.ndarray:
        """(n_kp, 6) annotation rows [flag, x, y, X, Y, Z]."""
        return np.hstack([self.points, self.kp3d])

    def draw(self, img: np.ndarray) -> np.ndarray:
        """Annotated copy of a display frame (reference update_disp)."""
        import cv2

        img2 = img.copy()
        cv2.putText(img2, f"kp: {self.current}", (0, 40),
                    cv2.FONT_HERSHEY_PLAIN, 3, (0, 0, 0), 3, cv2.LINE_AA)
        for i in range(self.n_kp):
            if self.points[i, 0] > 0:
                x, y = int(self.points[i, 1]), int(self.points[i, 2])
                cv2.putText(img2, str(i), (x, y + 20),
                            cv2.FONT_HERSHEY_PLAIN, 1.5, (0, 0, 255), 2,
                            cv2.LINE_AA)
                cv2.drawMarker(img2, (x, y), (0, 0, 255), thickness=2,
                               markerSize=15)
        return img2


def load_existing(config_path: str) -> dict:
    """Previous annotations per camera id (if any), for resumed
    labeling sessions (reference mct:133-141)."""
    import h5py

    base = os.path.dirname(config_path)
    path = os.path.join(base, "cagepoints_annotation.h5")
    data: dict = {}
    if os.path.exists(path):
        with h5py.File(path, "r") as f:
            for k in f.keys():
                data[k] = np.asarray(f[k])
    return data


def label_cage_keypoints(config_path: str) -> str:
    """Interactive driver over all cameras; writes
    ``cagepoints_annotation.h5``. Requires a display (cv2.imshow) —
    raises RuntimeError headless so callers fall back to
    ``save_cage_annotations`` with externally produced rows."""
    import cv2
    import yaml

    if not os.environ.get("DISPLAY") and os.name != "nt":
        raise RuntimeError(
            "label_cage_keypoints needs a display; headless "
            "environments should write annotations programmatically "
            "via calib.workflow.save_cage_annotations")

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    base = os.path.dirname(config_path)
    kp3d = np.loadtxt(os.path.join(base, cfg["cagekeypoint_position"]),
                      delimiter=",")
    vid_dir = os.path.join(base, cfg["cagekeypoint_vid_folder"])
    existing = load_existing(config_path)

    data: dict = {}
    wname = "label cage keypoints"
    for cam_id in cfg["camera_id"]:
        cam_id = str(cam_id)
        lab = CageLabeler(kp3d, existing.get(cam_id))
        vfs = glob.glob(os.path.join(vid_dir, f"*{cam_id}*.mp4"))
        if not vfs:
            print(f"[labeler] no video for camera {cam_id}, skipping")
            continue
        cap = cv2.VideoCapture(vfs[0])
        ok, frame = cap.read()
        if not ok:
            continue
        img = cv2.resize(frame, (DISPLAY_W, DISPLAY_H))

        def on_mouse(event, x, y, flag, params):
            if event == cv2.EVENT_LBUTTONDOWN:
                lab.add_point(x, y)
            elif event == cv2.EVENT_MBUTTONDOWN:
                lab.remove_point()
            cv2.imshow(wname, lab.draw(img))

        cv2.namedWindow(wname)
        cv2.setMouseCallback(wname, on_mouse)
        cv2.imshow(wname, lab.draw(img))
        while True:
            k = cv2.waitKey()
            if k == ord("a"):
                prev = max(cap.get(cv2.CAP_PROP_POS_FRAMES) - 10, 0)
                cap.set(cv2.CAP_PROP_POS_FRAMES, prev)
                ok, frame = cap.read()
            elif k == ord("d"):
                ok, frame = cap.read()
            elif k == ord("w"):
                lab.next_kp()
            elif k == ord("s"):
                lab.prev_kp()
            elif k == 32:
                break
            if ok and frame is not None:
                img = cv2.resize(frame, (DISPLAY_W, DISPLAY_H))
            cv2.imshow(wname, lab.draw(img))
        data[cam_id] = lab.rows()
    cv2.destroyAllWindows()

    from macaque_tpu_torch.calib.workflow import save_cage_annotations

    return save_cage_annotations(config_path, data)
