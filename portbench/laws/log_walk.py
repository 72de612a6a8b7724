"""A walk: a block holds the steps ``±s`` in decades for each ``s`` of
``steps_decades``; request k sets ``clip(v_{k-1}·10^step, lo, hi)``, with
``v_{-1}`` the warm-up value.  A block's steps sum to zero, so the walk
comes back to where the block began.  Mix keys: ``lo``, ``hi``,
``steps_decades``."""
import numpy as np


def block(mix: dict) -> np.ndarray:
    s = np.asarray(mix["steps_decades"], dtype=float)
    return np.concatenate([s, -s])


def value(previous: float, item: float, mix: dict) -> float:
    return min(max(previous * 10.0 ** float(item), float(mix["lo"])),
               float(mix["hi"]))
