"""setup_s: process start to the first timed job (import, inputs, the
port's kernel build or its cached library, one warm job)."""


def read(run):
    return run.setup_s
