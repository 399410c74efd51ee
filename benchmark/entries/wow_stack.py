"""A stack of ``batch`` frames a call: ``wow_stack(stack,
with_coefficients=..., **options)`` → each frame's recon, and its whitened
planes where the traffic asks for them (see ``wow.py`` for the four
functions an entry gives)."""

from benchmark.reference import wow as ref


def _planes(traffic):
    return bool(traffic.get("with_coefficients", True))


def inputs(pool, traffic):
    batch = int(traffic["batch"])
    if pool.shape[0] % batch:
        raise ValueError("the frame pool must hold whole batches")
    return [pool[i:i + batch] for i in range(0, pool.shape[0], batch)]


def call(wt, config, traffic, cast=None):
    kw = ref.options(config)
    with_coefficients = _planes(traffic)

    def run(x):
        return wt.wow_stack(x if cast is None else x.to(cast),
                            with_coefficients=with_coefficients, **kw)
    return run


def split(result, x):
    recon, planes = result
    return [(x[b], recon[b], [] if planes is None
             else [planes[b, s] for s in range(planes.shape[1])])
            for b in range(x.shape[0])]


def reference(frame, config, traffic):
    return ref.wow(frame, keep_planes=_planes(traffic), **ref.options(config))
