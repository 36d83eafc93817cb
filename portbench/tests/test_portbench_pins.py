"""The readings of the benchmark's yardstick, pinned: the seeded state
dicts, the program as the harness builds it, and the output check's
numbers (the program's and the control's) of a tiny ``parity.occupied``
and ``serving.occupied`` run on one seed, each equal bit for bit to what
the harness read before the networks' architectures moved into files of
their own (``archs/``). The numbers were read with one CPU thread (torch
2.13 on an x86-64 Xeon), as the test reads them: the sums of CPU
kernels split by thread."""

import hashlib

import pytest
import torch

from portbench_tiny import tiny_cell
from portbench import harness
from portbench.readings import readings
from portbench.weights import seeded_state

SEED = 2 ** 31 + 4242
ROLES = ("detector", "pose", "classifier")
# first 16 hex digits of the SHA-256 of each state dict: keys, shapes,
# dtypes and bytes, in key order
SEEDED = {
    "parity.detector": "a08a6fbb140f18f0",
    "parity.pose": "50f57f8328ab9fb5",
    "parity.classifier": "07e553abf9dcc39e",
    "serving.detector": "a08a6fbb140f18f0",
    "serving.pose": "50f57f8328ab9fb5",
    "serving.classifier": "07e553abf9dcc39e",
}
PROGRAM = {
    "parity.detector": "053cc7fc6db61a6f",
    "parity.pose": "50f57f8328ab9fb5",
    "parity.classifier": "07e553abf9dcc39e",
    "serving.detector": "053cc7fc6db61a6f",
    "serving.pose": "530da8bc12242c69",
    "serving.classifier": "07e553abf9dcc39e",
}
# float.hex of each number, by cell and side
NUMBERS = {
    "parity.occupied.program": {
        "det_maps": "0x1.f76f880000000p-22",
        "det_rpn": "0x1.36868c0000000p-22",
        "det_props": "0x0.0p+0",
        "det_box_px": "0x0.0p+0",
        "det_score": "0x0.0p+0",
        "det_cut": "0x0.0p+0",
        "det_count": "0x0.0p+0",
        "det_nms_iou": "0x1.f6818e530c394p-2",
        "pose_hm": "0x1.4aa5900000000p-24",
        "pose_kp_px": "0x0.0p+0",
        "pose_kp_score": "0x0.0p+0",
        "id_prob": "0x0.0p+0",
        "rows": "0x0.0p+0",
    },
    "parity.occupied.control": {
        "det_maps": "0x1.73bfa00000000p-4",
        "det_rpn": "0x1.a9a0960000000p-5",
        "det_props": "0x1.851eb851eb852p-2",
        "det_box_px": "0x1.5600000000000p-3",
        "det_score": "0x1.8ed0000000000p-10",
        "det_cut": "0x1.4448000000000p-11",
        "det_count": "0x0.0p+0",
        "det_nms_iou": "0x1.01225757cc2b5p-2",
        "pose_hm": "0x1.998e160000000p-6",
        "pose_kp_px": "0x1.2a19080000000p+19",
        "pose_kp_score": "0x1.f1c8000000000p-11",
        "id_prob": "0x1.36c0000000000p-15",
    },
    "serving.occupied.program": {
        "det_maps": "0x1.f76f880000000p-22",
        "det_rpn": "0x1.36868c0000000p-22",
        "det_props": "0x0.0p+0",
        "det_box_px": "0x0.0p+0",
        "det_score": "0x0.0p+0",
        "det_cut": "0x0.0p+0",
        "det_count": "0x0.0p+0",
        "det_nms_iou": "0x1.f6818e530c394p-2",
        "pose_hm": "0x1.4065660000000p-10",
        "pose_kp_px": "0x0.0p+0",
        "pose_kp_score": "0x0.0p+0",
        "id_prob": "0x0.0p+0",
        "rows": "0x0.0p+0",
    },
    "serving.occupied.control": {
        "det_maps": "0x1.73bfa00000000p-4",
        "det_rpn": "0x1.a9a0960000000p-5",
        "det_props": "0x1.851eb851eb852p-2",
        "det_box_px": "0x1.5600000000000p-3",
        "det_score": "0x1.8ed0000000000p-10",
        "det_cut": "0x1.4448000000000p-11",
        "det_count": "0x0.0p+0",
        "det_nms_iou": "0x1.01225757cc2b5p-2",
        "pose_hm": "0x1.92f0140000000p-5",
        "pose_kp_px": "0x1.1f6c800000000p+20",
        "pose_kp_score": "0x1.c300000000000p-11",
        "id_prob": "0x1.8880000000000p-16",
    },
}


def _digest(sd: dict) -> str:
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["parity", "serving"])
def test_seeded_state_dicts_are_unchanged(config):
    n = tiny_cell(f"{config}.occupied")["config"]["networks"]
    for role in ROLES:
        sd = seeded_state(role, n[role], SEED, "cpu")
        assert _digest(sd) == SEEDED[f"{config}.{role}"], role


@pytest.mark.parametrize("config", ["parity", "serving"])
def test_program_is_built_as_before(config):
    cell = tiny_cell(f"{config}.occupied")
    _, nets = harness.build_program(cell["config"], cell["mix"], SEED,
                                    torch.device("cpu"))
    for role, net in zip(ROLES, nets):
        assert _digest(net.state_dict()) == PROGRAM[f"{config}.{role}"], role


@pytest.mark.parametrize("name", ["parity.occupied", "serving.occupied"])
def test_check_numbers_are_unchanged(name, one_thread):
    got = {f"{name}.{r['side']}": {k: float(v).hex() for k, v in r["numbers"].items()}
           for r in readings(tiny_cell(name), [SEED], {SEED}, 0.1,
                             torch.device("cpu"))}
    assert got == {k: v for k, v in NUMBERS.items() if k.startswith(name + ".")}
