"""The coarse kernel's share (%) of its byte roofline in a season cell."""

from perfbench.roofline import coarse_post_share as read  # noqa: F401
