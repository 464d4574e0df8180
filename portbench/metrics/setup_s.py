"""Seconds from the process's start to the window: the interpreter,
torch and the CUDA context, the inputs from the seed, the program's
set-up and the warm-up requests (in a checkout's first run, the build of
the kernels too)."""


def read(w):
    return w.setup_s
