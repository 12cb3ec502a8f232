"""Version of sushi-tpu.

The reference pins VERSION = '0.5.1' (see Sushi's sushi.py:41);
we start our own line at 0.1.0.
"""

VERSION = "0.1.0"
__version__ = VERSION
