"""A sweep: a block holds the ``B`` midpoints ``lo·(hi/lo)^((j+½)/B)`` of
``B`` equal bins of ``[lo, hi]`` in log, each a request's value.  Mix keys:
``lo``, ``hi``, ``block`` (``B``)."""
import numpy as np


def block(mix: dict) -> np.ndarray:
    lo, hi, B = float(mix["lo"]), float(mix["hi"]), int(mix["block"])
    return lo * (hi / lo) ** ((np.arange(B) + 0.5) / B)


def value(previous: float, item: float, mix: dict) -> float:
    return float(item)
