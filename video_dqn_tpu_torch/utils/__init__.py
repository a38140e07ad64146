"""General helpers (counterpart of video_dqn_tpu/utils, the reference's
util package): argmax and argmin with the first extremum winning a tie,
one_hot, pad_to, split_columns, chunks, angle_delta, unzip, and the
wide-column codec of data/schema.py."""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from ..data.schema import multi_add, multi_get  # noqa: F401  (util/pd.py's codec)


def unzip(pairs):
    return tuple(map(list, zip(*pairs)))


def unzip_arrays(pairs):
    return [np.array(x) for x in unzip(pairs)]


def one_hot(n: int, i: int) -> np.ndarray:
    r = np.zeros((n,))
    r[i] = 1
    return r


def pad_to(length: int, dat: np.ndarray) -> np.ndarray:
    """Zero-pad along axis 0 to `length` at the front, keeping the LAST
    elements when longer."""
    shape = list(dat.shape)
    shape[0] = length
    out = np.zeros(tuple(shape))
    if len(dat) > length:
        return dat[-length:]
    if len(dat) > 0:
        out[-len(dat):] = dat
    return out


padTo = pad_to  # the reference's name


def split_columns(obj: np.ndarray, widths: Sequence[int]):
    """Split the last axis into groups of the given widths."""
    if obj.shape[-1] != sum(widths):
        raise ValueError(f"shape sum {sum(widths)} incompatible with {obj.shape}")
    out, st = [], 0
    for wdt in widths:
        out.append(obj[..., st:st + wdt])
        st += wdt
    return tuple(out)


def chunks(lst, n: int):
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


def chunks_num(lst, n: int) -> List:
    """n evenly-sized chunks (the first ones take the remainder)."""
    low, rem = divmod(len(lst), n)
    out, ptr = [], 0
    for i in range(n):
        c = low + (1 if i < rem else 0)
        out.append(lst[ptr:ptr + c])
        ptr += c
    return out


def _first_extremum(items: Iterable, func: Callable, better: Callable) -> Tuple:
    index, best_val, best_el = None, None, None
    for i, el in enumerate(items):
        v = func(el)
        if best_val is None or better(v, best_val):
            index, best_val, best_el = i, v, el
    return index, best_el, best_val


def argmax(items: Iterable, func: Callable = lambda x: x) -> Tuple:
    """(index, element, value) of the FIRST maximum."""
    return _first_extremum(items, func, lambda a, b: a > b)


def argmin(items: Iterable, func: Callable = lambda x: x) -> Tuple:
    """(index, element, value) of the FIRST minimum."""
    return _first_extremum(items, func, lambda a, b: a < b)


def angle_delta(x: float, y: float) -> float:
    return math.atan2(math.sin(x - y), math.cos(x - y))


def rand_bool(rate: float, rng=None) -> bool:
    rng = rng or np.random.default_rng()
    return rng.uniform(0, 1) < rate
