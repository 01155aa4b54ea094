"""The card's peak allocated memory over the window, in GiB
(``torch.cuda.max_memory_allocated``, reset as the window opens)."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
