"""``chip_regression.py`` on the CPU: its fixtures are byte-identical to
``tools/regression.py``'s, its frame-accurate compare counts exactly, and
the default config passes in this process (``device="cpu"``) with its
exact expected line error counts."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import chip_regression  # noqa: E402

from tools import regression as jax_regression  # noqa: E402

FILES = ("ep.src.wav", "ep.dst.wav", "ep.jump.wav", "ep.srt", "ep.ass", "ep.ideal.srt", "ep.ideal.ass",
         "ep.jump.ideal.srt", "regression.json")
FPS = 23.976
FRAME = 1001.0 / 24000.0


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    """(the port's fixtures directory, ``tools/regression.py``'s)."""
    port, jax = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    chip_regression.make_fixtures(str(port))
    jax_regression.make_fixtures(str(jax))
    return str(port), str(jax)


def test_fixture_files_are_all_compared(fixture_dirs):
    assert sorted(os.listdir(fixture_dirs[1])) == sorted(FILES)


@pytest.mark.parametrize("name", FILES)
def test_make_fixtures_byte_identical_to_tools_regression(fixture_dirs, name):
    port, jax = fixture_dirs
    with open(os.path.join(port, name), "rb") as got, open(os.path.join(jax, name), "rb") as want:
        assert got.read() == want.read()


@pytest.mark.parametrize("ideal", ["ep.ideal.srt", "ep.ideal.ass", "ep.jump.ideal.srt"])
def test_compare_scripts_ideal_against_itself(fixture_dirs, ideal):
    path = os.path.join(fixture_dirs[0], ideal)
    assert chip_regression.compare_scripts(path, path, FPS) == 0


@pytest.mark.parametrize("moved", [1, 7, 20])
def test_compare_scripts_counts_lines_moved_one_frame(fixture_dirs, tmp_path, moved):
    """``moved`` lines (every third one) moved one frame later count
    exactly ``moved`` errors."""
    from sushi_tpu_torch.text.subs import load_script

    ideal = os.path.join(fixture_dirs[0], "ep.ideal.srt")
    script = load_script(ideal)
    for event in script.events[::3][:moved]:
        event.set_shift(FRAME, 0.0)
        event.apply_shift()
    out = str(tmp_path / "moved.srt")
    script.save_to_file(out)
    assert chip_regression.compare_scripts(ideal, out, FPS) == moved


def test_compare_scripts_counts_a_lost_line(fixture_dirs, tmp_path):
    from sushi_tpu_torch.text.subs import load_script

    ideal = os.path.join(fixture_dirs[0], "ep.ideal.srt")
    script = load_script(ideal)
    count = len(script.events)
    del script.events[5]
    out = str(tmp_path / "short.srt")
    script.save_to_file(out)
    assert chip_regression.compare_scripts(ideal, out, FPS) == 1 + count


def _test_names(kind):
    # the names make_fixtures writes, without running it at collection
    return {"tests": ["srt-uniform-shift", "ass-uniform-shift", "srt-no-grouping", "srt-15s-jump-recovery"],
            "season_tests": ["season-batch"], "wav_tests": ["wav-load-budget"]}[kind]


def test_config_names(fixture_dirs):
    with open(os.path.join(fixture_dirs[0], "regression.json"), encoding="utf-8") as handle:
        config = json.load(handle)
    for kind in ("tests", "season_tests", "wav_tests"):
        assert [test["name"] for test in config[kind]] == _test_names(kind)
    assert [test["expected_errors"] for test in config["tests"]] == [0, 3, 0, 0]
    assert [job["expected_errors"] for job in config["season_tests"][0]["jobs"]] == [0, 0]


@pytest.mark.parametrize("name", _test_names("tests") + _test_names("season_tests") + _test_names("wav_tests"))
def test_default_config_passes_on_cpu(fixture_dirs, name):
    """Each test of the default config, in this process on the CPU, with its
    exact expected count (ASS 3)."""
    config = os.path.join(fixture_dirs[0], "regression.json")
    assert chip_regression.run_config(config, device="cpu", only=name) == []


def test_a_changed_count_fails(fixture_dirs, tmp_path):
    """An expected count that the run does not give exactly fails the test,
    both above and below."""
    base = fixture_dirs[0]
    for expected in (2, 4):
        test = {"name": "ass-off-by-one", "src": "ep.src.wav", "dst": "ep.dst.wav", "script": "ep.ass",
                "ideal": "ep.ideal.ass", "expected_errors": expected, "fps": FPS}
        assert not chip_regression.run_test(test, base, device="cpu")


def test_cli_failure_fails_the_test(fixture_dirs):
    test = {"name": "missing-src", "src": "none.wav", "dst": "ep.dst.wav", "script": "ep.srt",
            "ideal": "ep.ideal.srt", "expected_errors": 0}
    assert not chip_regression.run_test(test, fixture_dirs[0], device="cpu")
