"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB: how large a scene a user can fit."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
