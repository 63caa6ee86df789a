"""peak_gb: the highest ``torch.cuda.max_memory_allocated()`` over the window
on the fullest card, resident data included (1 GB = 1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
