"""Milliseconds a camera-frame in the perception's uploads: the program's
``perception.upload`` span (each ``put_batch_sharded`` of
``TorchPerception._run``: a chunk's frames for detect, pose and classify,
and the box tables) summed over the window's segments; nothing where the
program has no such span."""


def read(run, trace):
    seg = [s[2] for s in run.segments if s[0] >= 0 and s[2] is not None]
    if not seg or not all("perception.upload" in r for r in seg):
        return None
    cf = len(run.frames) * len(seg)
    return 1e3 * sum(r["perception.upload"] for r in seg) / cf
