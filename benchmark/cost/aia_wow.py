"""Work of one call of standard WOW (configuration ``aia_wow``)."""

from benchmark.cost.h100 import WHITEN_SCALE_OPS, wow_work


def work(config: dict, traffic: dict) -> dict:
    return wow_work(config, traffic, WHITEN_SCALE_OPS)
