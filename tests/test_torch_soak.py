"""``chip_soak.py`` on the CPU (``device="cpu"``, the plain PyTorch path):
its fixtures are ``tools/soak.py``'s, its contracts hold on the first
iterations of seed 0 and catch planted faults, its batched shifts equal
``sushi_tpu``'s, and the season and pooled soaks pass."""

import hashlib
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_soak  # noqa: E402
from sushi_tpu_torch.align import batcher, machine  # noqa: E402
from sushi_tpu_torch.ops import sqdiff  # noqa: E402

from tools import soak as jax_soak  # noqa: E402

DRAWS = 8


def _digest(path):
    with open(path, "rb") as handle:
        return hashlib.sha256(handle.read()).hexdigest()


def _draws(random_fixture, seed, directory):
    """The first ``DRAWS`` fixtures of ``seed``: (events, shift, scenario,
    src WAV digest, dst WAV digest) each."""
    rng = np.random.RandomState(seed)
    draws = []
    for _ in range(DRAWS):
        src, dst, events, shift, scenario = random_fixture(rng, str(directory))
        draws.append((events, shift, str(scenario), _digest(src), _digest(dst)))
    return draws


@pytest.fixture(scope="module")
def both_draws(tmp_path_factory):
    """{seed: (tools/soak.py's draws, chip_soak.py's draws)} for seeds 0, 1."""
    directory = tmp_path_factory.mktemp("draws")
    return {seed: tuple(_draws(tool.random_fixture, seed, directory) for tool in (jax_soak, chip_soak))
            for seed in (0, 1)}


@pytest.mark.parametrize("seed,draw", [(seed, draw) for seed in (0, 1) for draw in range(DRAWS)])
def test_random_fixture_equals_tools_soak(both_draws, seed, draw):
    """Same events, shift and scenario, and byte-equal WAVs."""
    want, got = both_draws[seed]
    assert got[draw] == want[draw]


def _iteration_rng(index, directory, seed=0):
    """``RandomState(seed)`` advanced past the fixtures of the iterations
    before ``index``, as the soak's loop leaves it."""
    rng = np.random.RandomState(seed)
    for _ in range(index):
        chip_soak.random_fixture(rng, str(directory))
    return rng


@pytest.mark.parametrize("index", [0, 1, 2])
def test_run_iteration_holds_both_contracts(index, tmp_path):
    assert chip_soak.run_iteration(_iteration_rng(index, tmp_path), index, device="cpu", workdir=str(tmp_path))


def test_batched_shifts_equal_jax_on_iteration_0(tmp_path):
    """On iteration 0's episode the port's batched search gives
    ``sushi_tpu``'s ``calculate_shifts`` shifts, group by group."""
    from sushi_tpu.align.batcher import calculate_shifts as jax_calculate_shifts
    from sushi_tpu.media.stream import AudioStream as JaxAudioStream
    from sushi_tpu.text.subs import ScriptEvent as JaxScriptEvent
    from sushi_tpu_torch.media.stream import AudioStream
    from sushi_tpu_torch.text.subs import ScriptEvent

    src_path, dst_path, events, _, _ = chip_soak.random_fixture(np.random.RandomState(0), str(tmp_path))

    def shifts(stream, event, calculate, **kwargs):
        groups = [[event(i + 1, s, e, "x")] for i, (s, e) in enumerate(events)]
        src, dst = (stream(path, chip_soak.SAMPLE_RATE, "uint8") for path in (src_path, dst_path))
        return [r.shift for r in calculate(src, dst, groups, *chip_soak.SEARCH, **kwargs)]

    want = shifts(JaxAudioStream, JaxScriptEvent, jax_calculate_shifts)
    got = shifts(AudioStream, ScriptEvent, batcher.calculate_shifts, device="cpu")
    assert len(got) == len(events) and got == want


def _planted_execute(monkeypatch, faulted, samples, rescore):
    """``DeviceMatcher.execute`` with a fault: the results of the requests
    that ``faulted(request, requests)`` names move ``samples`` later, their
    scores re-measured there (float64 TM_SQDIFF_NORMED) when ``rescore``,
    else kept."""
    original = batcher.DeviceMatcher.execute

    def execute(self, requests):
        results = original(self, requests)
        for request in requests:
            if not faulted(request, requests):
                continue
            score, time, abs_sample = results[request]
            moved = abs_sample + samples
            if rescore:
                pat_start, pat_len = self._patterns.bounds(request.group_idx, request.part)
                src = self._src_dev.numpy().astype(np.float32) * np.float32(1.0 / 255.0)
                dst = self._dst_dev.numpy().astype(np.float32) * np.float32(1.0 / 255.0)
                score = float(sqdiff.oracle_sqdiff_normed(src[pat_start : pat_start + pat_len],
                                                          dst[moved : moved + pat_len])[0])
            results[request] = (score, time + samples / float(chip_soak.SAMPLE_RATE), moved)
        return results

    monkeypatch.setattr(batcher.DeviceMatcher, "execute", execute)


def _caught(caplog, tmp_path):
    """Runs iteration 0 of seed 0; returns its result and the kinds of the
    mismatches it logged."""
    with caplog.at_level(logging.INFO, logger="chip_soak"):
        ok = chip_soak.run_iteration(_iteration_rng(0, tmp_path), 0, device="cpu", workdir=str(tmp_path))
    return ok, {record.args[3] for record in caplog.records if len(record.args or ()) == 4}


def test_planted_batched_fault_is_caught(monkeypatch, caplog, tmp_path):
    """The first result of every batched call (more than one request)
    moved 2 samples, with the worse score found there: contract 1 fails."""
    _planted_execute(monkeypatch, lambda request, requests: request is requests[0] and len(requests) > 1,
                     2, rescore=True)
    ok, kinds = _caught(caplog, tmp_path)
    assert not ok and "batching" in kinds


def test_planted_tie_is_not_waived(monkeypatch, caplog, tmp_path):
    """Every result of group 1 moved 1 s with its score kept, in the batched
    and the sequential drive alike: contract 1 holds, and the oracle's tie
    waiver must not excuse two good matches 1 s apart that tie in score."""
    _planted_execute(monkeypatch, lambda request, requests: request.group_idx == 1,
                     chip_soak.SAMPLE_RATE, rescore=False)
    ok, kinds = _caught(caplog, tmp_path)
    assert not ok and kinds == {"value"}


def test_planted_fail_state_is_caught(monkeypatch, caplog, tmp_path):
    """The batched search failing a group the oracle syncs is caught, though
    its score is unchanged (contract 1 sees a bit-equal tie)."""
    original = batcher.calculate_shifts

    def failing_last(*args, **kwargs):
        results = original(*args, **kwargs)
        results[-1].shift = None
        return results

    monkeypatch.setattr(batcher, "calculate_shifts", failing_last)
    ok, kinds = _caught(caplog, tmp_path)
    assert not ok and kinds == {"fail-state"}


def _result(shift, diff):
    return machine.GroupResult(0.0, 1.0, shift, diff)


SAMPLE = 1.0 / chip_soak.SAMPLE_RATE


@pytest.mark.parametrize(
    "batched,sequential,mismatch",
    [
        (_result(1.0, 0.01), _result(1.0, 0.01), False),
        (_result(1.0, 0.5), _result(3.0, 0.5), False),  # bit-equal tie: a tie-break, not a decision
        (_result(1.0, 0.01), _result(1.0 + SAMPLE, 0.01 + 1e-9), True),
        (_result(1.0, 0.01), _result(1.0, 0.01 + 3e-4), True),  # equal shifts, scores too far apart
        (_result(None, 0.5), _result(1.0, 0.5), False),  # contract 2 judges fail-states
    ],
)
def test_batching_contract(batched, sequential, mismatch):
    assert bool(chip_soak.batching_mismatches([batched], [sequential])) == mismatch


@pytest.mark.parametrize(
    "batched,oracle,kind",
    [
        (_result(1.0, 0.01), _result(1.0 + SAMPLE, 0.02), None),  # within 1.5 samples
        (_result(1.0, 0.01), _result(1.0 + 2 * SAMPLE, 0.01 + 1e-6), None),  # tie, nearby
        (_result(1.0, 0.5), _result(4.0, 0.5 + 1e-6), None),  # tie, both poor
        (_result(1.0, 0.01), _result(2.0, 0.01), "value"),  # tie alone: good picks 1 s apart
        (_result(1.0, 0.01), _result(1.0 + 2 * SAMPLE, 0.01 + 1e-3), "value"),  # nearby alone
        (_result(1.0, 0.5), _result(4.0, 0.3), "value"),  # poor alone
        (_result(None, 0.5), _result(1.0, 0.5), "fail-state"),
        (_result(1.0, 0.5), _result(None, 0.5), "fail-state"),
        (_result(None, 0.5), _result(None, 0.7), None),
    ],
)
def test_oracle_contract(batched, oracle, kind):
    found = chip_soak.oracle_mismatches([batched], [oracle])
    assert [entry[3] for entry in found] == ([] if kind is None else [kind])


def test_season_iteration_byte_identical(tmp_path):
    assert chip_soak.run_season_iteration(np.random.RandomState(0), 0, episodes=3, device="cpu",
                                          workdir=str(tmp_path))


def test_pooled_iteration_keeps_contract_1(monkeypatch, tmp_path):
    """With the pooled search at P = 4 (the module constant, restored
    after) the batched shifts still equal a sequential drive's."""
    pooled = []
    original = sqdiff._match_pooled

    def counting(*args, **kwargs):
        pooled.append(args[0].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(batcher, "_COARSE_POOL_ENV", 4)
    monkeypatch.setattr(sqdiff, "_match_pooled", counting)
    counts = {}
    assert chip_soak.run_iteration(_iteration_rng(0, tmp_path), 0, device="cpu", oracle_hard=False, workdir=str(tmp_path),
                                   counts=counts)
    assert pooled, "the pooled search never ran"
    assert "oracle_mismatches" in counts
