"""setup_s: from the end of ``import torch`` to the window's start (host
clock): the CUDA driver and context, the program's import, loading (and on a
first run building) its kernels, making the data from the seed, and two warm
calls. The torch import before it is reported beside it, as
``torch_import_s``."""


def read(run):
    return run.setup_s
