"""The "model" layer: alignment steps in fixed shapes, for device checks
and multi-device runs."""
