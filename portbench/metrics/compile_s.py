"""``compile_s``: seconds of the port's front end in set-up, a span around
``Model.observe`` and ``Model.compile`` (the DSL's metadata collection and
the compiled program)."""


def read(ctx):
    return ctx.spans.get("compile")
