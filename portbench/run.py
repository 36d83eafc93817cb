"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload parity.occupied --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout on a machine with an NVIDIA card. Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (camera-frames), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(and with ``--trace 1`` the trace's ``breakdown``), and last ``checks``,
each number of the output check beside its limit; the checks are also the
last lines of standard error. Exits non-zero, with no result, without a
card, or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import importlib.util

    if importlib.util.find_spec("macaque_tpu_torch") is None:
        print("the program under test, macaque_tpu_torch, is not in this "
              "checkout", file=sys.stderr)
        return 4
    import torch

    from portbench import files, harness

    cell = files.cell(args.workload, files.bench(ROOT))
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), torch.device("cuda", 0), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, value, limit in lines:
        print(f"check {name} {float(value)!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    from portbench.files import use_checkout_caches

    use_checkout_caches()
    sys.exit(main())
