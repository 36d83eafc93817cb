"""Host waits on the card a camera-frame on the perception path: the sum
of the program's ``host_reads.<site>`` counters over the window's
segments (the device-to-host reads ``nms``, ``roi_buckets``,
``k2_check`` and ``gather``, and the copies from pageable memory that wait
on the card's stream, ``upload`` and the constants' sites); nothing where
the program has no such counter."""


def read(run, trace):
    seg = [s[2] for s in run.segments if s[0] >= 0 and s[2] is not None]
    reads = [sum(v for k, v in r.items() if k.startswith("host_reads."))
             for r in seg if any(k.startswith("host_reads.") for k in r)]
    if not seg or len(reads) != len(seg):
        return None
    return sum(reads) / (len(run.frames) * len(seg))
