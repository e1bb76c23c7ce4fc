"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the full 700 W power limit), the yardstick of every
roofline share the benchmark reports.  Copied from the port's
``launch/roofline.py``."""

#: f32 outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12


def bound_s(ops: float, nbytes: float) -> tuple:
    """``(least seconds on the card, "operations" or "bytes")``: the larger
    of the operations over the f32 rate and the bytes over the memory
    rate."""
    to, tb = ops / F32_FLOPS, nbytes / HBM_BW
    return (to, "operations") if to >= tb else (tb, "bytes")
