"""Three-term roofline of one step on the H100, from its counted work:
``repro.launch.roofline`` with the card's peaks in place of the TPU's.

    compute term    = FLOPs / (chips * peak_FLOPs)
    memory term     = bytes / (chips * HBM_bw)
    collective term = collective_bytes / link_bw

The counts come from ``launch.step_cost.count`` (a step traced on ``meta``
tensors, never run), per device; the collective bytes are the per-device
payload of the shard group's exchanges.  :func:`bound` is the least time
of one kernel call, the larger of its bytes over the memory rate and its
operations over their peak rate (``chip_smoke.py``'s ``bound_ms``).

Hardware constants: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, no sparsity, at the full 700 W power limit), but for the device
memory, which is read off the card.
"""

from __future__ import annotations

#: H100 SXM data sheet: dense bf16 tensor-core rate, FLOP/s
PEAK_FLOPS = 989e12
#: H100 SXM data sheet: f32 outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
#: H100 SXM data sheet: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: H100 SXM data sheet: NVLink 4, bytes/s per direction (900 GB/s both ways)
LINK_BW = 450e9
#: device memory of an NVIDIA H100 80GB HBM3 as PyTorch's allocator sees it
#: (``torch.cuda.get_device_properties(0).total_memory``; nvidia-smi's
#: ``memory.total`` reads 81,559 MiB): what a step's peak must fit in.
#: ``chip_smoke.py``'s ``costs`` phase checks it against the card.
HBM_BYTES = 85_017_493_504


def fits(peak_bytes: int) -> bool:
    """True where a step's peak live bytes fit one card's memory."""
    return peak_bytes <= HBM_BYTES


def bound(nbytes, nops, peak=None) -> tuple:
    """``(least ms on the card, "bytes" or "operations")``: the larger of
    the bytes over the memory rate and the operations over their peak rate
    (f32 outside the tensor cores unless ``peak`` is given)."""
    peak = peak or F32_FLOPS
    tb, to = nbytes / HBM_BW * 1e3, nops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def roofline(cost: dict, coll: dict, n_chips: int, model_flops: float = 0.0,
             per_device_cost: bool = True) -> dict:
    """The three terms in seconds + bottleneck.

    ``cost`` holds ``"flops"`` and ``"bytes accessed"``, per device unless
    ``per_device_cost=False`` (whole-program numbers); ``coll["total_bytes"]``
    the collective bytes of one device."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("total_bytes", 0))
    div = 1.0 if per_device_cost else float(n_chips)
    t_compute = flops / div / PEAK_FLOPS
    t_memory = bytes_ / div / HBM_BW
    t_coll = cbytes / LINK_BW        # the collective bytes are per device
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    out = dict(terms)
    out["bottleneck"] = bottleneck.replace("_s", "")
    out["hlo_flops_per_device"] = flops / div
    out["hlo_bytes_per_device"] = bytes_ / div
    out["collective_bytes_per_device"] = cbytes
    if model_flops:
        total_hlo = flops / div * n_chips
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / max(total_hlo, 1.0)
        # roofline fraction: useful model FLOPs over the time the dominant
        # term implies at peak
        t_dom = max(terms.values())
        out["roofline_fraction"] = (model_flops / n_chips / PEAK_FLOPS) \
            / max(t_dom, 1e-30)
    return out


def train_model_flops(n_params_active: int, n_tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE)."""
    return 6.0 * n_params_active * n_tokens


def decode_model_flops(n_params_active: int, batch: int) -> float:
    """One decode step processes ``batch`` tokens at 2*N FLOPs each."""
    return 2.0 * n_params_active * batch
