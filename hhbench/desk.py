"""A desk's configuration read into numbers: year fractions and the
market parameters in the order of the reference (``PARAMS``)."""

from __future__ import annotations

import datetime as dt

from .reference.heston_mixing import PARAMS


def date(text: str) -> dt.date:
    return dt.date.fromisoformat(text)


def yearfrac(start: str, stop: str) -> float:
    """ACT/365 Fixed, the configurations' day count."""
    return (date(stop) - date(start)).days / 365.0


def params(market: dict) -> list:
    """The seven market parameters in ``PARAMS`` order, float."""
    return [float(market[name]) for name in PARAMS]
