"""Share of the traced window in which no kernel, copy or memset ran."""

from perfbench.roofline import idle_share as read  # noqa: F401
