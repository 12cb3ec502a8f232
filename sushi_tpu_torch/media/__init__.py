"""Host-side media layer: WAV ingest, demuxing, timecodes."""
