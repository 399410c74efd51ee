"""One frame a call: ``wow(frame, **options)`` → the recon and every
whitened plane, each judged against the plain reference.

An entry module gives the harness four functions:

* ``inputs(pool, traffic)`` — the call inputs, cycled in the loop;
* ``call(wt, config, traffic, cast)`` — the timed call on one input
  (``cast``: the input cast to that dtype first, the control);
* ``split(result, x)`` — after the window, each frame of input ``x`` with
  what the call returned for it: ``(frame, recon, [planes])``;
* ``reference(frame, config, traffic)`` — the plain reference's
  ``(recon, [planes])`` of one frame.
"""

from benchmark.reference import wow as ref


def inputs(pool, traffic):
    if int(traffic["batch"]) != 1:
        raise ValueError("wow takes one frame a call")
    return [pool[i] for i in range(pool.shape[0])]


def call(wt, config, traffic, cast=None):
    kw = ref.options(config)

    def run(x):
        return wt.wow(x if cast is None else x.to(cast), **kw)
    return run


def split(result, x):
    recon, coeffs = result
    return [(x, recon, [coeffs[s] for s in range(len(coeffs))])]


def reference(frame, config, traffic):
    return ref.wow(frame, keep_planes=True, **ref.options(config))
