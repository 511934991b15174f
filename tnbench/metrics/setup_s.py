"""Seconds from the process's start to the first timed call: imports,
the CUDA context, inputs, plan load, contractor build, warm-up (and, in
a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
