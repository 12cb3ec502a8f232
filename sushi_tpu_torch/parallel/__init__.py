"""Multi-device execution: device meshes, row-split matching, lag-split
wide-window search."""
