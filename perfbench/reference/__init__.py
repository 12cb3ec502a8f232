"""The plain reference that decides ``correct``.

A sync worked out again from the same generated files, with nothing of the
program: the analysis buffer from the WAV bytes (:mod:`.audio`), the search
groups, the commit/rewind state machine and an exact TM_SQDIFF_NORMED
argmin in float64 (:mod:`.search`), then the repair and smoothing
heuristics and the SRT writer (:mod:`.script`).  :func:`.sync.sync` runs
the whole of it for one script.

The host logic is a frozen copy of the behaviour that tp7/Sushi defines
(``sushi.py``, ``wav.py``, ``subs.py``, ``common.py``), the same behaviour
the program's host modules copy; only NumPy and plain PyTorch are used,
and the search runs in float64 on whatever device it is given.
"""
