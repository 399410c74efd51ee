"""One frame stored below float32 a call: ``wow(frame, **options)`` → the
recon and every whitened plane, each judged against the plain reference
on the same frame (which widens it exactly), as ``entries/wow.py``.

The one difference is the control: with ``cast`` the frame is rounded
through ``cast`` and back to its own type before the call, since the port
takes no frame below bfloat16; the call then sees a frame of ``cast``'s
precision, and the reference the frame as it was.
"""

from benchmark.entries.wow import inputs, reference, split  # noqa: F401
from benchmark.reference import wow as ref


def call(wt, config, traffic, cast=None):
    kw = ref.options(config)

    def run(x):
        return wt.wow(x if cast is None else x.to(cast).to(x.dtype), **kw)
    return run
