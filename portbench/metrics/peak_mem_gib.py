"""``peak_mem_gib`` (GiB): the most memory PyTorch's allocator held for
the program during the window on the fullest card of the cell
(``torch.cuda.max_memory_allocated`` of each card after a reset at the
window's start, the largest)."""


def read(ctx):
    return None if ctx.peak_mem_bytes is None else ctx.peak_mem_bytes / 2**30
