"""Multi-camera rig: stacked camera parameters + calibration file I/O.

Port of ``macaque_tpu/cameras/rig.py``: the rig stays a dataclass of numpy
arrays; ``omni()``, ``pinhole()`` and ``camera()`` return tensor cameras on
the card unless the caller asks for the CPU.

Loads the reference's calibration artifacts:
  * ``cam_intrinsic.h5``  with ``/<id>/{mtx, dist, K, xi, D}``
  * ``cam_extrinsic_optim.h5`` with ``/<id>/{rvec, tvec}``
  * anipose-style ``calibration.toml`` with per-camera sections
(reference: src/pipeline/step2_crossviewmatching.py:35-75,
src/pipeline/step4_aniposefiltering.py:101-138,
src/third_party/aniposelib/cameras.py:1998-2013).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from macaque_tpu_torch.cameras.fisheye import FisheyeCamera
from macaque_tpu_torch.cameras.omnidir import OmnidirCamera
from macaque_tpu_torch.cameras.pinhole import PinholeCamera
from macaque_tpu_torch.cameras.rotation import rodrigues
from macaque_tpu_torch.core.device import resolve_device


@dataclass
class CameraRig:
    """A calibrated multi-camera rig (host-side container).

    ``omni`` holds the omnidir (Mei) parameters stacked over cameras; ``mtx``
    / ``dist`` hold the auxiliary pinhole intrinsics the reference stores
    alongside (used by step4 to write the anipose calibration with the
    halved ``mtx`` quirk; reference: step4:116-130).
    """

    camera_ids: list[str]
    K: np.ndarray      # (n_cam, 3, 3)
    xi: np.ndarray     # (n_cam,)
    D: np.ndarray      # (n_cam, 4)
    rvec: np.ndarray   # (n_cam, 3)
    tvec: np.ndarray   # (n_cam, 3)
    mtx: Optional[np.ndarray] = None   # (n_cam, 3, 3) pinhole intrinsics
    dist: Optional[np.ndarray] = None  # (n_cam, n_dist)
    size: Optional[tuple[int, int]] = None  # (width, height)
    metadata: dict = field(default_factory=dict)
    # "omnidir": K/xi/D hold Mei parameters (pinhole loads map onto it
    # exactly with xi=0). "fisheye": K holds the pinhole matrix, D the
    # four equidistant coefficients, xi is unused (reference
    # FisheyeCamera, aniposelib cameras.py:339-421). Rigs are
    # homogeneous, like anipose's per-project `calibration.fisheye`
    # switch (calibrate.py:181).
    model: str = "omnidir"

    @property
    def n_cam(self) -> int:
        return len(self.camera_ids)

    def _tensors(self, device, dtype, *arrays):
        dev = resolve_device(device)
        return [torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
                for a in arrays]

    def camera(self, device=None, dtype=torch.float32):
        """Stacked tensor camera for this rig's model, on ``device`` (the
        card when None)."""
        if self.model == "fisheye":
            return FisheyeCamera(*self._tensors(
                device, dtype, self.K, self.D, self.rvec, self.tvec))
        return self.omni(device, dtype)

    def omni(self, device=None, dtype=torch.float32) -> OmnidirCamera:
        """Stacked omnidir tensor camera on ``device`` (the card when None)."""
        if self.model != "omnidir":
            raise ValueError(
                f"rig model is {self.model!r}; use camera() for the "
                "model-generic camera")
        return OmnidirCamera(*self._tensors(
            device, dtype, self.K, self.xi, self.D, self.rvec, self.tvec))

    def pinhole(self, device=None, dtype=torch.float32) -> PinholeCamera:
        if self.mtx is None or self.dist is None:
            raise ValueError("rig has no pinhole intrinsics")
        dist = np.zeros((self.n_cam, 5))
        dist[:, : self.dist.shape[1]] = self.dist
        return PinholeCamera(*self._tensors(
            device, dtype, self.mtx, dist, self.rvec, self.tvec))

    def pmat(self) -> np.ndarray:
        """(n_cam, 3, 4) extrinsics [R|t] (host numpy, float64)."""
        out = np.zeros((self.n_cam, 3, 4))
        out[:, :, :3] = rodrigues(
            torch.from_numpy(np.asarray(self.rvec, np.float64))).numpy()
        out[:, :, 3] = self.tvec
        return out

    def subset(self, indices: Sequence[int]) -> "CameraRig":
        idx = list(indices)
        return CameraRig(
            camera_ids=[self.camera_ids[i] for i in idx],
            K=self.K[idx],
            xi=self.xi[idx],
            D=self.D[idx],
            rvec=self.rvec[idx],
            tvec=self.tvec[idx],
            mtx=None if self.mtx is None else self.mtx[idx],
            dist=None if self.dist is None else self.dist[idx],
            size=self.size,
            metadata=dict(self.metadata),
            model=self.model,
        )

    def subset_by_names(self, names: Sequence[str]) -> "CameraRig":
        pos = {n: i for i, n in enumerate(self.camera_ids)}
        missing = [n for n in names if n not in pos]
        if missing:
            raise IndexError(f"camera names not in rig: {missing}")
        return self.subset([pos[n] for n in names])

    # ------------------------------------------------------------------ IO

    @staticmethod
    def from_h5(
        config_path: str,
        intrinsic_h5: Optional[str] = None,
        extrinsic_h5: Optional[str] = None,
    ) -> "CameraRig":
        """Load from the reference's YAML config + calibration h5 pair
        (reference: step2:35-75)."""
        import h5py
        import yaml

        with open(config_path) as f:
            cfg = yaml.safe_load(f)
        ids = [str(c) for c in cfg["camera_id"]]
        root = os.path.dirname(config_path)
        intrinsic_h5 = intrinsic_h5 or os.path.join(root, "cam_intrinsic.h5")
        extrinsic_h5 = extrinsic_h5 or os.path.join(root, "cam_extrinsic_optim.h5")

        K, xi, D, rvec, tvec, mtx, dist = [], [], [], [], [], [], []
        with h5py.File(intrinsic_h5, "r") as f:
            for cid in ids:
                K.append(np.asarray(f[f"/{cid}/K"]))
                xi.append(float(np.asarray(f[f"/{cid}/xi"]).ravel()[0]))
                D.append(np.asarray(f[f"/{cid}/D"]).ravel()[:4])
                if f"/{cid}/mtx" in f:
                    mtx.append(np.asarray(f[f"/{cid}/mtx"]))
                    dist.append(np.asarray(f[f"/{cid}/dist"]).ravel())
        with h5py.File(extrinsic_h5, "r") as f:
            for cid in ids:
                rvec.append(np.asarray(f[f"/{cid}/rvec"]).ravel())
                tvec.append(np.asarray(f[f"/{cid}/tvec"]).ravel())

        size = None
        if "img_size" in cfg:
            size = (int(cfg["img_size"][0]), int(cfg["img_size"][1]))
        return CameraRig(
            camera_ids=ids,
            K=np.stack(K),
            xi=np.asarray(xi),
            D=np.stack(D),
            rvec=np.stack(rvec),
            tvec=np.stack(tvec),
            mtx=np.stack(mtx) if mtx else None,
            dist=np.stack(dist) if dist else None,
            size=size,
        )

    def to_h5(self, config_dir: str) -> str:
        """Write the reference's calibration triple into ``config_dir``:
        ``config.yaml`` + ``cam_intrinsic.h5`` (``/<id>/{K,xi,D,mtx,dist}``)
        + ``cam_extrinsic_optim.h5`` (``/<id>/{rvec,tvec}``), with the
        OpenCV-compatible array shapes the reference reads back
        (step2:35-75, mct:393-431). Returns the config.yaml path."""
        import h5py
        import yaml

        os.makedirs(config_dir, exist_ok=True)
        cfg_path = os.path.join(config_dir, "config.yaml")
        cfg: dict = {"camera_id": [str(c) for c in self.camera_ids]}
        if self.size is not None:
            cfg["img_size"] = [int(self.size[0]), int(self.size[1])]
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)

        with h5py.File(os.path.join(config_dir, "cam_intrinsic.h5"), "w") as f:
            for i, cid in enumerate(self.camera_ids):
                g = f.create_group(str(cid))
                g["K"] = self.K[i].astype(np.float64)
                g["xi"] = np.array([[float(self.xi[i])]])
                g["D"] = self.D[i].astype(np.float64).reshape(1, -1)
                if self.mtx is not None:
                    g["mtx"] = self.mtx[i].astype(np.float64)
                    g["dist"] = self.dist[i].astype(np.float64).reshape(1, -1)
        with h5py.File(
            os.path.join(config_dir, "cam_extrinsic_optim.h5"), "w"
        ) as f:
            for i, cid in enumerate(self.camera_ids):
                g = f.create_group(str(cid))
                g["rvec"] = self.rvec[i].astype(np.float64).reshape(3, 1)
                g["tvec"] = self.tvec[i].astype(np.float64).reshape(3, 1)
        return cfg_path

    @staticmethod
    def from_calibration_toml(path: str) -> "CameraRig":
        """Load an anipose-format ``calibration.toml``
        (reference: cameras.py:1966-2013 load path)."""
        import tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)

        sections = sorted(
            (k for k in data if k.startswith("cam_")),
            key=lambda k: int(k.split("_")[1]),
        )
        ids, K, xi, D, rvec, tvec, mtx, dist = [], [], [], [], [], [], [], []
        size = None
        models = []
        for k in sections:
            c = data[k]
            ids.append(str(c.get("name", k)))
            mtx.append(np.asarray(c["matrix"], dtype=np.float64))
            dd = np.asarray(c.get("distortions", np.zeros(4)), dtype=np.float64).ravel()
            dist.append(dd)
            rvec.append(np.asarray(c["rotation"], dtype=np.float64).ravel())
            tvec.append(np.asarray(c["translation"], dtype=np.float64).ravel())
            if c.get("fisheye") and not (c.get("omnidir") or c.get("Omnidir")):
                # equidistant fisheye section (reference
                # FisheyeCamera.get_dict, cameras.py:361-365: matrix +
                # 4 distortion coefficients + fisheye=true)
                models.append("fisheye")
                K.append(np.asarray(c["matrix"], dtype=np.float64))
                xi.append(0.0)
                d4 = np.zeros(4)
                d4[: min(4, dd.shape[0])] = dd[:4]
                D.append(d4)
                if "size" in c and size is None:
                    size = (int(c["size"][0]), int(c["size"][1]))
                continue
            models.append("omnidir")
            if "K" in c or c.get("omnidir"):
                # omnidir (Mei) calibration: separate K/xi/D block
                K.append(np.asarray(c.get("K", np.eye(3)), dtype=np.float64))
                xi_val = c.get("xi", [0.0])
                xi.append(float(np.asarray(xi_val).ravel()[0]))
                D.append(np.asarray(c.get("D", np.zeros(4)),
                                    dtype=np.float64).ravel()[:4])
            else:
                # plain pinhole calibration (aniposelib Camera.get_dict:
                # matrix + distortions only). The Mei model with xi=0 IS
                # the pinhole model with (k1, k2, p1, p2) — exact, no
                # approximation (cameras/omnidir.py: m = X/Z at xi=0).
                # k3+ terms are not representable; parity pinned by
                # tests/test_golden_aniposelib.py::test_golden_pinhole.
                if dd.shape[0] > 4 and np.any(np.abs(dd[4:]) > 0):
                    import warnings

                    warnings.warn(
                        f"{k}: pinhole distortion terms beyond "
                        f"(k1,k2,p1,p2) ignored: {dd[4:]}")
                K.append(np.asarray(c["matrix"], dtype=np.float64))
                xi.append(0.0)
                d4 = np.zeros(4)
                d4[: min(4, dd.shape[0])] = dd[:4]
                D.append(d4)
            if "size" in c and size is None:
                size = (int(c["size"][0]), int(c["size"][1]))

        maxd = max(d.shape[0] for d in dist)
        dist_arr = np.zeros((len(dist), maxd))
        for i, d in enumerate(dist):
            dist_arr[i, : d.shape[0]] = d
        # flatten the [metadata] section (reference CameraGroup.load
        # sets cgroup.metadata = master_dict['metadata']); keep any
        # other top-level keys alongside so round-trips are lossless
        meta = {k: v for k, v in data.items()
                if not k.startswith("cam_") and k != "metadata"}
        meta.update(data.get("metadata", {}))
        model = models[0] if models else "omnidir"
        if any(m != model for m in models):
            raise ValueError(
                f"{path}: mixed camera models {sorted(set(models))} in one "
                "rig are not supported (anipose selects fisheye per "
                "project, calibrate.py:181)")
        return CameraRig(
            model=model,
            camera_ids=ids,
            K=np.stack(K),
            xi=np.asarray(xi),
            D=np.stack(D),
            rvec=np.stack(rvec),
            tvec=np.stack(tvec),
            mtx=np.stack(mtx),
            dist=dist_arr,
            size=size,
            metadata=meta,
        )

    def to_calibration_toml(self, path: str, halve_mtx: bool = False) -> None:
        """Write an anipose-format calibration.toml.

        ``halve_mtx=True`` reproduces step4's quirk of halving the first two
        rows of the pinhole matrix when materializing per-run calibration
        (reference: step4:116-121).
        """
        from macaque_tpu_torch.utils.tomlwriter import dump_toml

        doc: dict = {}
        if self.model == "fisheye":
            # reference FisheyeCamera.get_dict (cameras.py:361-365):
            # matrix + 4 equidistant coefficients + fisheye=true
            for i, cid in enumerate(self.camera_ids):
                doc[f"cam_{i}"] = {
                    "name": str(cid),
                    "size": list(self.size) if self.size else [2048, 1536],
                    "matrix": self.K[i].tolist(),
                    "distortions": self.D[i].tolist(),
                    "rotation": self.rvec[i].tolist(),
                    "translation": self.tvec[i].tolist(),
                    "fisheye": True,
                }
            doc["metadata"] = {"adjusted": False, **self.metadata}
            dump_toml(doc, path)
            return
        for i, cid in enumerate(self.camera_ids):
            m = self.mtx[i].copy() if self.mtx is not None else self.K[i].copy()
            if halve_mtx:
                m[:2, :] = m[:2, :] / 2
            sec = {
                "name": str(cid),
                "size": list(self.size) if self.size else [2048, 1536],
                "matrix": m.tolist(),
                "distortions": (
                    self.dist[i].tolist() if self.dist is not None else [0.0] * 4
                ),
                "rotation": self.rvec[i].tolist(),
                "translation": self.tvec[i].tolist(),
                "xi": [float(self.xi[i])],
                "K": self.K[i].tolist(),
                "D": self.D[i].tolist(),
                # the reference's CameraGroup.from_dicts keys on lowercase
                # 'omnidir' (cameras.py:1972-1983) while its own get_dict
                # writes 'Omnidir' (cameras.py:481) and its shipped
                # calibration_tmpl.toml carries lowercase — emit both so
                # either loader reconstructs an OmnidirCamera
                "omnidir": True,
                "Omnidir": True,
                "fisheye": False,
            }
            doc[f"cam_{i}"] = sec
        doc["metadata"] = {"adjusted": False, **self.metadata}
        dump_toml(doc, path)
