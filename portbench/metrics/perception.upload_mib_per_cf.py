"""MiB a camera-frame placed on the device by the perception: the
program's ``perception.upload_bytes`` counter summed over the window's
segments; nothing where the program has no such counter."""


def read(run, trace):
    seg = [s[2] for s in run.segments if s[0] >= 0 and s[2] is not None]
    if not seg or not all("perception.upload_bytes" in r for r in seg):
        return None
    total = sum(r["perception.upload_bytes"] for r in seg)
    return total / 2 ** 20 / (len(run.frames) * len(seg))
