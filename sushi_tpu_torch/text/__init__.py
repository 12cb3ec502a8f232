"""Host-side text handling: subtitle scripts, chapters, keyframes, times."""
