"""``torch.cuda.max_memory_allocated()`` over the warm-up loop (the same
calls, as many in flight), after a reset, in MiB."""


def read(ctx):
    if ctx.loop_peak_bytes <= 0:
        return None
    return ctx.loop_peak_bytes / 2 ** 20
