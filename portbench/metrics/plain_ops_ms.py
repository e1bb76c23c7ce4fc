"""``plain_ops_ms``: device ms a step of the kernels launched under
PyTorch's own ``aten::`` operators (the Dirichlets' ELBO terms, the
``prior + stats`` update, the gathers and fills around the port's
kernels), from ``torch.profiler`` over the profiled steps after the timed
window: the operators' self device time, summed, over the steps."""


def read(ctx):
    p = ctx.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return p["aten_device_s"] / p["n_steps"] * 1e3
