"""Work of one call of standard WOW on bfloat16 frames (configuration
``aia_wow_bf16``), and the frozen bytes of the bfloat16 route's whitening
launches, which ``metrics/lowp_roofline.py`` reads.

The route's launches are the JAX plan's (the port's ``models/
lowp_route.py``), taken here as the configuration defines them: one group
of the first ``GROUP`` scales (kernel A's streamed group), then from the
float32 carry a pair ``(s, s+1)`` (kernel E's stream) where a residue class
holds at most ``PAIR_MAX_CLASS_ROWS`` rows, ``H >> s``, and a next scale
exists, else one deep step (kernel A's stream).  Each array a launch reads
is read once and each it writes written once: the bfloat16 frame, the
bfloat16 whites, the float32 carries and the float32 recon, which the
route accumulates between its launches (every launch after the group reads
and writes it) and rounds once, after them.
"""

from benchmark.cost.h100 import WHITEN_SCALE_OPS, auto_scales, wow_work

#: scales of the route's group, and the most rows a residue class of a
#: pair may hold (the JAX plan's deep start and pair rule at 4096²)
GROUP = 4
PAIR_MAX_CLASS_ROWS = 32
#: bytes an element: the frame and whites in bfloat16, carries and recon
#: in float32
LOWP, WIDE = 2, 4


def launches(config: dict) -> list:
    """The route's whitening launches: ``("group", g)``, ``("step", s)``
    and ``("pair", s)``."""
    h, w = int(config["height"]), int(config["width"])
    n = config["n_scales"] or auto_scales(h, w)
    out, s = [("group", min(n, GROUP))], min(n, GROUP)
    while s < n:
        if s + 1 < n and (h >> s) <= PAIR_MAX_CLASS_ROWS:
            out.append(("pair", s))
            s += 2
        else:
            out.append(("step", s))
            s += 1
    return out


def kernel_bytes(config: dict) -> float:
    """The bytes the route's whitening launches move in one call of one
    frame: the group reads the frame and writes its whites, the carry and
    the recon's first sum; a step reads the carry and the recon and writes
    c_next, its white and the recon; a pair the same with two whites."""
    pixels = float(int(config["height"]) * int(config["width"]))
    total = 0.0
    for kind, arg in launches(config):
        if kind == "group":
            total += LOWP + arg * LOWP + WIDE + WIDE
        else:
            whites = 2 if kind == "pair" else 1
            total += WIDE + WIDE + whites * LOWP + 2 * WIDE
    return total * pixels


def work(config: dict, traffic: dict) -> dict:
    return dict(wow_work(config, traffic, WHITEN_SCALE_OPS),
                kernel_bytes=kernel_bytes(config) * int(traffic["batch"]))
