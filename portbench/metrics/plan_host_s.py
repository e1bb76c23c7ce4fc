"""``plan_host_s``: host seconds of the ``zstats`` owner plans' sorts and
gathers in set-up: the port's own span ``vmp.owner_plans``
(``repro_torch.trace``, its latest instance's seconds in the totals),
which ``vmp.program_plans`` opens inside ``runtime.make_step`` on its cache
miss, apart from the index streams' and the plans' copies to the card.
Owner plans are built only for the card, so a CPU run reads nothing, nor
does a program without the span."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    t = trace.totals().get("vmp.owner_plans")
    return None if t is None else t["last_s"]
