"""The program's entries that a cell can drive, one module each, found by
the configuration's ``entry``: ``perfbench/entries/<entry>.py`` defines
``Entry(config, manifest, out_dir, device)`` with ``capture`` (a context
manager that keeps the search's results), ``pool`` (the steps in which
every job runs once), ``warm()``, ``step(index, seen, span)`` and
``metrics(steps, window)``."""

import contextlib
import importlib
import os


def load(name):
    """The ``Entry`` class of ``perfbench/entries/<name>.py``."""
    return importlib.import_module("perfbench.entries." + name).Entry


def read_text(path):
    try:
        with open(path, encoding="utf-8-sig", newline="") as handle:
            return handle.read()
    except OSError:
        return None


def remove(path):
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
