"""setup_s: from the process's start to the window's start (host clock):
imports, the kernel library's load (and build, in a checkout's first run),
the inputs, the program's set-up and the warm-up."""


def read(run):
    return run.setup_s
