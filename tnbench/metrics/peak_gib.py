"""``torch.cuda.max_memory_allocated()`` over set-up and the window, in
GiB, read before the reference runs (the program's side only)."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
