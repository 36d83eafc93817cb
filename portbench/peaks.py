"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates, at
its 700 W power limit (NVIDIA's data sheet)."""

BF16_FLOP_PER_S = 989e12       # bf16 tensor cores
INT8_OPS_PER_S = 1979e12       # int8 tensor cores
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3

PEAK = {"bf16": BF16_FLOP_PER_S, "int8": INT8_OPS_PER_S, "f32": F32_FLOP_PER_S}


def least_seconds(work: dict) -> float:
    """The least time the peaks allow for ``work``, operations by the
    type they run in ({"bf16": n, "int8": n, "f32": n})."""
    return sum(n / PEAK[kind] for kind, n in work.items())


def bound_seconds(n_bytes: float, n_ops: float, peak: float) -> tuple:
    """(least seconds, what bounds it) of a kernel call: its bytes moved
    once over the HBM rate against its operations over ``peak``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
