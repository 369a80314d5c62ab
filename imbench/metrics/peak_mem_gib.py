"""``peak_mem_gib``: the most device memory the allocator held for the
window's jobs (``torch.cuda.max_memory_allocated`` after a reset at the
window's start), in GiB. Nothing where the run had no card."""


def read(win):
    return win.peak_bytes / 2 ** 30 if win.peak_bytes else None
