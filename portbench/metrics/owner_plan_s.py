"""``owner_plan_s``: seconds of the engine's set-up, a span around
``runtime.make_step``: the program's index streams copied to the device and
the ``zstats`` owner plans built on the host (``vmp.program_plans``,
``ops.host_plan``) and copied over."""


def read(ctx):
    return ctx.spans.get("make_step")
