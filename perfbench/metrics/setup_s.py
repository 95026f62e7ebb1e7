"""Seconds from the process's start to the first measured request: imports,
the CUDA context, the kernels' library, the server and the warm-up."""


def read(run):
    return run.setup_s
