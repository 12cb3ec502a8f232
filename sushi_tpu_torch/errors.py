"""Error types for sushi-tpu.

Behavioral parity: the reference raises a single ``SushiError`` for every
user-facing failure (see Sushi's common.py:4-5) and exits with
code 2 from the CLI.  We keep that contract.
"""


class SushiError(Exception):
    """Any user-facing failure: bad input files, bad flags, bad media."""
