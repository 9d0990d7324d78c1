"""Set-up: from the process's start to the window's (imports, the
weights drawn, the model built, the kernels built or loaded, the cell's
shapes warmed up)."""


def read(run):
    return run.setup_s
