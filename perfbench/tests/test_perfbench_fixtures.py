"""The generator: the same seed gives the same bytes, and every seed the
same sizes."""

import hashlib
import os

from conftest import tiny_cell
from perfbench import fixtures

SEED = 2**31 + 12345  # more than 32 signed bits


def _digests(manifest):
    paths = [p for ep in manifest["episodes"] for p in [ep["src"], ep["dst"]] + [s["path"] for s in ep["scripts"]]]
    out = {}
    for path in paths:
        with open(path, "rb") as handle:
            out[os.path.basename(path)] = hashlib.sha256(handle.read()).hexdigest()
    return out


def test_same_seed_same_bytes(tmp_path):
    cell = tiny_cell("tiny_season", "tiny_season_recut")
    first = fixtures.fixtures(str(tmp_path / "a"), cell["config"], cell["traffic"], SEED)
    second = fixtures.fixtures(str(tmp_path / "b"), cell["config"], cell["traffic"], SEED)
    assert _digests(first) == _digests(second)
    other = fixtures.fixtures(str(tmp_path / "c"), cell["config"], cell["traffic"], SEED + 1)
    assert _digests(other) != _digests(first)


def test_every_seed_the_same_sizes(tmp_path):
    cell = tiny_cell("tiny_season", "tiny_season_recut")
    sizes = []
    for seed in (1, 2**40 + 3):
        manifest = fixtures.fixtures(str(tmp_path / str(seed)), cell["config"], cell["traffic"], seed)
        sizes.append([(sorted(s["events"] for s in ep["scripts"]), ep["inserts"]) for ep in manifest["episodes"]])
    assert sizes[0] == sizes[1]
    assert [inserts for _, inserts in sizes[0]] == [[[0.5, 3.0]], [], [[0.5, 2.0]]]


def test_the_cache_keeps_the_newest_seed(tmp_path):
    cell = tiny_cell()
    root = str(tmp_path)
    fixtures.fixtures(root, cell["config"], cell["traffic"], 5)
    again = fixtures.fixtures(root, cell["config"], cell["traffic"], 5)
    fixtures.fixtures(root, cell["config"], cell["traffic"], 6)
    kept = os.listdir(os.path.join(root, cell["config"]["name"]))
    assert len(kept) == 1 and not os.path.exists(again["episodes"][0]["src"])


def test_shifts_are_not_on_a_sample_grid(tmp_path):
    """Base shifts are drawn in seconds, and the destination is the source
    moved by the fraction of a sample that is left."""
    import numpy as np

    cell = tiny_cell("tiny_season", "tiny_season_steady")
    fractions = []
    for seed in range(3):
        shift = fixtures.fixtures(str(tmp_path / str(seed)), cell["config"], cell["traffic"], seed)["episodes"][0]["shift"]
        fractions.append(abs(shift * 12000 - round(shift * 12000)))
    assert max(fractions) > 0.01
    ramp = np.arange(8, dtype=np.int16) * 100
    assert np.allclose(fixtures.delay(ramp, 2.25 / 12000, 12000)[:6], [0, 0, 0, 75, 175, 275])
    assert np.allclose(fixtures.delay(ramp, -1.5 / 12000, 12000)[:3], [150, 250, 350])
