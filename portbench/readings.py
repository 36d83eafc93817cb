"""The readings that the output check's limits are set from, for one cell:
the program's numbers over many seeds and the control's over a few, in
one process (set-up is most of a run).

    python3 portbench/readings.py --workload parity.occupied \
        --seeds 11 12 13 --control-seeds 11 12 13 --seconds 5

For each seed: set-up, a window of ``--seconds`` (at least the sampled
segment), the program's numbers; for a control seed also the control's,
the reference one precision step lower put in the program's place on the
same frames and box tables (``check.control_judged``). One JSON line per
reading on standard output. The benchmark's runs never run the control.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seeds, control_seeds, seconds, device):
    import torch

    from portbench import check, harness

    for seed in seeds:
        t = time.perf_counter()
        run = harness.Run(cell, seed, device, t)
        try:
            run.setup()
            run.window(seconds)
            run.free_program()
            numbers = run.check()
            yield {"seed": seed, "side": "program", "numbers": numbers,
                   "seconds": time.perf_counter() - t}
            if seed in control_seeds:
                ref = check.Reference(run.cfg, seed, run.device,
                                      run.mix["fg_bias"])
                low = check.Reference(run.cfg, seed, run.device,
                                      run.mix["fg_bias"], lower=True)
                control = {}
                for key in sorted(run.rec.captures):
                    judged = check.control_judged(run.judged(key), low)
                    for k, v in check.compare(judged, ref).items():
                        control[k] = max(control.get(k, 0.0), v)
                del ref, low
                yield {"seed": seed, "side": "control", "numbers": control,
                       "seconds": time.perf_counter() - t}
        finally:
            run.close()
            del run
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    import torch

    from portbench import files

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = files.cell(args.workload, files.bench(ROOT))
    for line in readings(cell, args.seeds, set(args.control_seeds),
                         args.seconds, torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    from portbench.files import use_checkout_caches

    use_checkout_caches()
    sys.exit(main())
