"""Set-up: process start to the first timed wave or step (s)."""


def read(ctx):
    return ctx["setup_s"]
