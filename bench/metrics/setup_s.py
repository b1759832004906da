"""Set-up: from the start of the process to the window's start (imports,
the graph, WindGP, the pack, the warm-up query or job, and each kernel's
build where none is built yet)."""


def read(r):
    return r.setup_s
