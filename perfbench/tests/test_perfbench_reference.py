"""The plain reference against the port at a tiny size."""

import glob
import os

import numpy as np
import pytest

from conftest import tiny_cell
from perfbench import cell as cell_run
from perfbench import fixtures
from perfbench.reference import audio, script


def test_analysis_buffers_equal_the_programs(tmp_path, cache):
    """The reference's uint8 buffer of each WAV equals the one the port's
    ingest (its native decoder) prepares."""
    from sushi_tpu_torch.media.stream_cache import load_pair

    for config, traffic in (("tiny_season", "tiny_season_steady"), ("tiny_season", "tiny_season_recut")):
        cell = tiny_cell(config, traffic)
        manifest = fixtures.fixtures(str(tmp_path / traffic), cell["config"], cell["traffic"], 21)
        for episode in manifest["episodes"]:
            streams = load_pair(episode["src"], episode["dst"], 12000, "uint8")
            for path, stream in zip((episode["src"], episode["dst"]), streams):
                want = audio.analysis_buffer(path)
                np.testing.assert_array_equal(want.data, np.asarray(stream.data))
                assert (want.sample_count, want.padding_size) == (stream.sample_count, stream.padding_size)


def test_srt_round_trip(tmp_path, cache):
    cell = tiny_cell()
    manifest = fixtures.fixtures(cache, cell["config"], cell["traffic"], 4)
    for path in glob.glob(os.path.join(os.path.dirname(manifest["episodes"][0]["src"]), "*.srt")):
        with open(path, encoding="utf-8-sig", newline="") as handle:
            text = handle.read()
        assert script.write_srt(script.parse_srt(text)) == text


@pytest.mark.parametrize("traffic", ["tiny_season_steady", "tiny_season_recut"])
def test_the_season_agrees_with_the_reference(traffic, cache, one_thread):
    """A season, with inserts (one past the 10 s window) in the recut mix,
    synced by the port's season path and by the reference: every number
    within its limit, the shifts exactly equal."""
    result = cell_run.run(tiny_cell("tiny_season", traffic), 9, 0.1, False, "cpu", cache, 0.0)
    assert result["correct"] and result["attempted"] == 3
    assert result["checks"]["shift_gap"]["value"] == 0
    assert result["ctx"]["telemetry"]["rounds"] >= result["ctx"]["passes"]
