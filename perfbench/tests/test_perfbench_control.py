"""The comparison fails what it must: the control, and a run whose timed
path is broken underneath."""

import pytest

from conftest import tiny_cell
from perfbench import cell as cell_run
from perfbench import control

MIXES = ["tiny_season_steady", "tiny_season_recut"]


@pytest.mark.parametrize("traffic", MIXES)
def test_the_control_is_not_correct(traffic, cache, one_thread):
    """The reference in bfloat16 in the program's place fails the score
    limit, and so ``check.verdict`` under the configuration's limits; the
    program on the same inputs keeps it."""
    cell = tiny_cell("tiny_season", traffic)
    limit = cell["config"]["limits"]["score_gap"]
    for seed in (1, 2):
        readings = control.readings(cell, seed, "cpu", cache)
        assert readings["program"]["score_gap"] <= limit < readings["control"]["score_gap"]
        assert readings["program_correct"] and not readings["control_correct"]
        assert readings["buffer_mismatches"] == 0 and readings["failed"] == 0


def _unchanged_state(monkeypatch):
    """The search's results never reach the events."""
    from sushi_tpu_torch.align import machine

    monkeypatch.setattr(machine, "apply_group_results", lambda groups, results: None)


def _broken_rounds(monkeypatch, alter):
    """Every round of the season (and of the whole-stream seed) altered
    after the executor returns."""
    from sushi_tpu_torch import season
    from sushi_tpu_torch.align import batcher

    real = batcher.execute_planned_multi

    def broken(items, *args, **kwargs):
        return alter(items, real(items, *args, **kwargs))

    monkeypatch.setattr(batcher, "execute_planned_multi", broken)
    monkeypatch.setattr(season, "execute_planned_multi", broken)


def _half_left_out(monkeypatch):
    """The second half of every round is not searched: its rows read as
    cv2's no-match (score 1.0 at the window's first lag)."""
    def alter(items, results):
        for _, item in items[len(items) // 2:]:
            results[item.key] = (1.0, item.start_time, item.win_start)
        return results

    _broken_rounds(monkeypatch, alter)


def _answer_altered(monkeypatch):
    """The last answer of every round one analysis sample late (the first
    is often a fast-path probe whose answer the search then drops)."""
    def alter(items, results):
        _, item = items[-1]
        score, found, sample = results[item.key]
        results[item.key] = (score, found + 1.0 / item.sample_rate, sample + 1)
        return results

    _broken_rounds(monkeypatch, alter)


@pytest.mark.parametrize("traffic", MIXES)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, traffic, monkeypatch, cache, one_thread):
    cell = tiny_cell("tiny_season", traffic)
    sound = cell_run.run(cell, 5, 0.1, False, "cpu", cache, 0.0)
    assert sound["correct"]
    fault(monkeypatch)
    broken = cell_run.run(cell, 5, 0.1, False, "cpu", cache, 0.0)
    assert not broken["correct"]
