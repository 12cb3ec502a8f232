"""Alignment: search-group construction, the shift-search state machine,
its batched device executor, and post-processing heuristics."""
