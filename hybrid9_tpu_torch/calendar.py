"""Leap-aware simulation calendar.

A copy of ``hybrid9_tpu/calendar.py``.  Replaces the reference's
``time_BOY`` beginning-of-year table built at SOURCE/INIT.f90:844-859: day
indices since 1860-01-01 (1-based), Gregorian leap rule applied to
``jyear - 1`` exactly as the reference does.
"""

from __future__ import annotations

import numpy as np

EPOCH_YEAR = 1860
LAST_YEAR = 2300


def is_leap(year: int) -> bool:
    """Gregorian leap-year rule.

    Note the reference applies this to ``jyear - 1`` when computing the day
    count added going from year ``jyear-1`` to ``jyear`` (INIT.f90:846-857),
    i.e. the increment is the length of the *previous* year — standard.
    """
    if year % 4 != 0:
        return False
    if year % 100 != 0:
        return True
    return year % 400 == 0


def days_in_year(year: int) -> int:
    return 366 if is_leap(year) else 365


def time_boy_table(first_year: int = EPOCH_YEAR, last_year: int = LAST_YEAR
                   ) -> np.ndarray:
    """1-based day index of Jan 1 for each year in [first_year, last_year].

    ``table[y - first_year]`` equals the reference's
    ``time_BOY(y - 1859)`` when ``first_year == 1860`` (INIT.f90:844-859).
    """
    years = np.arange(first_year, last_year + 1)
    lengths = np.array([days_in_year(int(y)) for y in years], dtype=np.int64)
    table = np.empty_like(lengths)
    table[0] = 1
    table[1:] = 1 + np.cumsum(lengths[:-1])
    return table


def time_boy(year: int) -> int:
    """Day index (1-based, since 1860-01-01) of the start of ``year``."""
    if year < EPOCH_YEAR or year > LAST_YEAR:
        raise ValueError(f"year {year} outside calendar range")
    total = 1
    for y in range(EPOCH_YEAR, year):
        total += days_in_year(y)
    return total


def decade_of_year(year: int) -> int:
    """PGF decade index: 1 = 1901-1910, ..., 12 = 2011-2012.

    Reference: HYBRID9.f90:103 (``syr = (iDEC-1)*10 + 1901``).
    """
    if year < 1901:
        raise ValueError("PGF forcing starts in 1901")
    return (year - 1901) // 10 + 1


def decade_year_span(idec: int) -> tuple[int, int]:
    """(first, last) calendar year of PGF decade ``idec``.

    Reference: HYBRID9.f90:103-113 — decade 12 holds only 2011-2012.
    """
    syr = (idec - 1) * 10 + 1901
    eyr = syr + 9 if idec < 12 else syr + 1
    return syr, eyr
