"""Work of one call of bilateral WOW (configuration ``aia_wow_bilateral``)."""

from benchmark.cost.h100 import BIL_OPS, BIL_WHITEN_OPS, wow_work


def work(config: dict, traffic: dict) -> dict:
    return wow_work(config, traffic, BIL_OPS + BIL_WHITEN_OPS)
