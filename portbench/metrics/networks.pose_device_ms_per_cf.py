"""Device milliseconds a camera-frame of the kernels that the pose
network's calls launched (the ``net.pose`` range), in the traced segment;
nothing where the segment ran no pose."""


def read(run, trace):
    if trace is None or "net.pose" not in trace["by_range"]:
        return None
    _, _, frames = run.crops(lambda s: s == -2)
    return 1e3 * trace["by_range"]["net.pose"] / frames
