"""The fixture writers of the root scripts: ``chip_smoke.write_srt`` and
``write_ass`` write the bytes ``tests/fixtures.py``'s writers write, and
every writer of ``chip_smoke.py``, ``chip_soak.py`` and
``chip_regression.py`` runs without importing JAX or the JAX package (a
subprocess each: this test process imported both)."""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

from tests import fixtures  # noqa: E402
from tests.test_pipeline import EVENTS  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EVENT_SETS = {
    "pipeline": EVENTS,
    # rounding edges of both formats: half milliseconds and centiseconds,
    # minute and hour carries
    "edges": [(0.0, 0.0005, "a"), (1.0005, 1.0049, "b"), (59.9995, 60.005, "c"), (3599.9995, 3600.0, "d"),
              (12.345, 7261.125, "e, with a comma")],
}


@pytest.mark.parametrize("events", sorted(EVENT_SETS))
def test_write_srt_bytes_equal_tests_fixtures(tmp_path, events):
    want, got = str(tmp_path / "want.srt"), str(tmp_path / "got.srt")
    fixtures.write_srt(want, EVENT_SETS[events])
    chip_smoke.write_srt(got, EVENT_SETS[events])
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("comments", [None, [1, 3]])
@pytest.mark.parametrize("events", sorted(EVENT_SETS))
def test_write_ass_bytes_equal_tests_fixtures(tmp_path, events, comments):
    want, got = str(tmp_path / "want.ass"), str(tmp_path / "got.ass")
    fixtures.write_ass(want, EVENT_SETS[events], comments)
    chip_smoke.write_ass(got, EVENT_SETS[events], comments)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


WRITERS = {
    "chip_smoke.synth_pair": "chip_smoke.synth_pair(out, seconds=30, count=6, shift=1.5, seed=3, audio_seed=4, "
                             "span=1.0, gap=0.5, gap_span=1.0, jump=12.0, corrupt=True)",
    "chip_soak.random_fixture": "chip_soak.random_fixture(np.random.RandomState(0), out)",
    "chip_soak.season_fixture": "chip_soak.season_fixture(np.random.RandomState(0), out, episodes=2)",
    "chip_regression.make_fixtures": "chip_regression.make_fixtures(out)",
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_fixture_writer_imports_nothing_of_jax(tmp_path, writer):
    code = textwrap.dedent(
        """
        import os, sys
        import numpy as np
        import chip_regression, chip_smoke, chip_soak
        out = sys.argv[1]
        %s
        assert os.listdir(out), "nothing written"
        held = chip_smoke.reference_modules()
        assert not held, "the writer imported %%s" %% held
        """ % WRITERS[writer]
    )
    result = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO_ROOT,
                            env=dict(os.environ, PYTHONPATH=REPO_ROOT), capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]


@pytest.mark.parametrize("name,held", [("jax", True), ("jax.numpy", True), ("jaxlib", True), ("sushi_tpu", True),
                                        ("sushi_tpu.text.timefmt", True), ("sushi_tpu_torch", False),
                                        ("jaxtyping", False)])
def test_reference_modules_names_jax_and_the_jax_package(monkeypatch, name, held):
    """The run-time guard of ``chip_smoke.py`` (before its last lines)."""
    monkeypatch.setitem(sys.modules, name, sys.modules.get(name) or object())
    assert (name in chip_smoke.reference_modules()) == held
