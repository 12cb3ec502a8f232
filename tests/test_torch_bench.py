"""``chip_bench.py`` on the CPU (``device="cpu"``, the plain path at its
rehearsal sizes): every cell returns its schema and is correct, a run of
the script imports nothing of JAX, its last line is small; its kernel-shape model and
its cv2 baseline equal ``bench.py``'s, and a wrong script fails its cell
and the run.  Also: ``chip_smoke.season_fixtures`` with several jump
slots writes the 12-episode season byte for byte as it did with one."""

import hashlib
import inspect
import json
import logging
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

import bench  # noqa: E402
import chip_bench  # noqa: E402
import chip_smoke  # noqa: E402
from sushi_tpu.align import batcher as jax_batcher  # noqa: E402
from sushi_tpu.align import machine as jax_machine  # noqa: E402
from sushi_tpu_torch import pipeline  # noqa: E402
from sushi_tpu_torch.align import batcher  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = {"cell", "correct", "metrics", "samples", "spread"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: the suite's workers
    share the cores, and among them a many-threaded torch ran its cells
    30-60x slower than alone, where one thread ran as fast as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(*argv, env=None, timeout=900):
    return subprocess.run([sys.executable, os.path.join(REPO_ROOT, "chip_bench.py"), *argv], cwd=REPO_ROOT,
                          env=dict(os.environ, PYTHONPATH=REPO_ROOT, **(env or {})), capture_output=True, text=True,
                          timeout=timeout)


def _lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def work_dir(tmp_path_factory):
    """One work directory for the module's cells: fixtures written once."""
    return str(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", chip_bench.CELLS)
def test_cell_on_cpu_is_correct_with_its_schema(monkeypatch, work_dir, name):
    monkeypatch.setenv("SUSHI_STREAM_CACHE", os.path.join(work_dir, "stream_cache"))
    record = chip_bench.run_cell(name, "cpu", work_dir, **chip_bench.REHEARSAL.get(name, {}))
    assert record.get("correct"), record
    assert set(record) == SCHEMA
    metric = chip_bench.HEADLINE_METRIC[name]
    assert record["spread"]["metric"] == metric
    assert record["spread"]["min"] <= record["metrics"][metric] <= record["spread"]["max"]
    # the device's idle share needs a card's profiler trace, the baseline's
    # ratio a headline_warm run of the same process (main fills it)
    assert (record["metrics"][chip_bench.SUMMARY_METRIC[name]] is None) == (name in ("search_round", "baseline"))


# the cells of the run in a subprocess: every one but the three heaviest on
# the CPU (pathological, whose wide windows it pays for, and the seasons),
# and checks, whose soak and regression modules their own tests run without
# JAX (tests/test_torch_fixtures.py, tests/test_torch_regression.py)
LIGHT_CELLS = ("headline_warm", "headline_cold", "search_round", "launch_floor", "kernel_shapes", "baseline")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """``chip_bench.py --device cpu --in-process`` with the light cells, one
    thread (see :func:`one_thread`)."""
    cells = [arg for name in LIGHT_CELLS for arg in ("--cell", name)]
    result = _script("--device", "cpu", "--in-process", *cells, "--work-dir", str(tmp_path_factory.mktemp("run")),
                     env={"OMP_NUM_THREADS": "1"})
    return result, _lines(result.stdout)


def test_cpu_run_passes_and_imports_nothing_of_jax(rehearsal):
    """The script exits 1 (with its reason on stderr) when its process
    holds ``jax`` or ``sushi_tpu*`` at the end: here it exits 0."""
    result, lines = rehearsal
    assert "imported JAX" not in result.stderr
    assert result.returncode == 0, result.stderr[-3000:]
    assert [line["cell"] for line in lines[:-1]] == list(LIGHT_CELLS)
    assert all(line["correct"] for line in lines[:-1])


def test_last_line_is_small_json_naming_every_cell(rehearsal):
    result, lines = rehearsal
    last = result.stdout.splitlines()[-1]
    assert len(last.encode()) < 2048
    summary = json.loads(last)
    assert summary["card"] == "cpu"
    assert list(summary["cells"]) == list(LIGHT_CELLS)
    assert summary["cells"]["baseline"]["vs_baseline"] > 0
    # and at its largest: a long card name, every cell with a float
    records = [{"cell": name, "correct": True, "metrics": {chip_bench.SUMMARY_METRIC[name]: 1 / 3}}
               for name in chip_bench.CELLS]
    assert len(chip_bench.summary_line("NVIDIA H100 80GB HBM3, 700.00 W" * 3, records)) < 2048


@pytest.mark.parametrize("pool", [0, 4])
@pytest.mark.parametrize("fft_size,batch", chip_bench.BENCH_SHAPES)
def test_shape_model_equals_bench_py(monkeypatch, fft_size, batch, pool):
    """GFLOP and gathered GB of each of bench.py's shapes by its formulas
    (bench.py:589, 643-644), with the JAX package's flop model and pooling."""
    monkeypatch.setattr(jax_batcher, "_COARSE_POOL_ENV", pool)
    monkeypatch.setattr(batcher, "_COARSE_POOL_ENV", pool)
    jax_pool = jax_batcher._coarse_pool_for(fft_size, 30000)
    want = (batch * jax_batcher.kernel_flop_model(fft_size, 32768, coarse_pool=jax_pool or 1) / 1e9,
            batch * fft_size * 2 * 4 / 1e9)
    port_pool = batcher._coarse_pool_for(fft_size, 30000)
    assert port_pool == jax_pool
    assert chip_bench.shape_model(fft_size, batch, 32768, port_pool) == want


def test_baseline_equals_bench_measure_baseline(monkeypatch, tmp_path):
    """On a 60 s episode: the cv2 engine's group shifts and written .srt
    equal ``bench.measure_baseline``'s, and the port's CLI sync's."""
    paths = chip_bench.headline_paths(str(tmp_path / "fixtures"), chip_bench.REHEARSAL_HEADLINE)
    kept = []
    run_search = jax_machine.run_search

    def keeping(*args, **kwargs):
        kept.append(run_search(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(bench, "BENCH_DIR", str(tmp_path / "bench"))
    os.makedirs(bench.BENCH_DIR)
    monkeypatch.setattr(jax_machine, "run_search", keeping)
    bench.measure_baseline(*paths)
    port_out = str(tmp_path / "port.cv2.srt")
    _, _, calls, results = chip_bench.cv2_sync(paths, port_out)
    want = [r.shift for r in kept[0]]
    assert len(kept) == 2 and [r.shift for r in kept[1]] == want  # bench.py's cold and warm passes
    assert calls > 0 and [r.shift for r in results] == want
    with open(os.path.join(bench.BENCH_DIR, "out.cv2.srt"), "rb") as a, open(port_out, "rb") as b:
        assert a.read() == b.read()

    cli_out = str(tmp_path / "cli.srt")
    _, recorder, _ = chip_smoke.sync_episode(paths, cli_out, "cpu")
    assert [r.shift for r in recorder.results] == want
    with open(cli_out, "rb") as a, open(port_out, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture
def quiet_port_log():
    """``chip_bench.main`` quiets the port's log for its run: restored after."""
    log = logging.getLogger("sushi_tpu")
    level = log.level
    yield
    log.setLevel(level)


def test_wrong_script_fails_the_cell_and_the_run(monkeypatch, capsys, tmp_path, quiet_port_log):
    original = pipeline.postprocess_events

    def shifted(events, **kwargs):
        original(events, **kwargs)
        for event in events:
            if not event.linked:
                event.adjust_shift(0.25)

    monkeypatch.setattr(pipeline, "postprocess_events", shifted)
    monkeypatch.setattr(chip_smoke, "reference_modules", lambda: [])  # this process holds JAX; the script's does not
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "cache"))
    code = chip_bench.main(["--device", "cpu", "--in-process", "--cell", "headline_warm",
                            "--work-dir", str(tmp_path / "bench")])
    lines = _lines(capsys.readouterr().out)
    assert code == 1
    assert lines[0]["cell"] == "headline_warm" and lines[0]["correct"] is False
    assert "s off" in lines[0]["error"]
    assert lines[-1]["cells"] == {"headline_warm": {"correct": False}}


def test_merge_takes_the_median_of_the_process_medians():
    records = [
        {"cell": "pathological", "correct": True, "samples": [s],
         "metrics": {"seconds": s, "rounds": 13, "buckets": {"786432": [3, 8, 1]}, "per": [s, 2 * s], "none": None}}
        for s in (0.3, 0.1, 0.2)
    ]
    merged = chip_bench.merge("pathological", records)
    assert merged["correct"] and merged["processes"] == 3
    assert merged["metrics"] == {"seconds": 0.2, "rounds": 13, "buckets": {"786432": [3, 8, 1]}, "per": [0.2, 0.4],
                                 "none": None}
    assert merged["samples"] == [0.3, 0.1, 0.2]
    assert merged["spread"] == {"metric": "seconds", "min": 0.1, "max": 0.3, "of": "per-process medians"}
    records[1] = {"cell": "pathological", "correct": False, "error": "a group shift is off"}
    assert chip_bench.merge("pathological", records) == {
        "cell": "pathological", "correct": False, "error": "a group shift is off", "processes": 3}


def test_cells_run_in_fresh_processes(tmp_path):
    result = _script("--device", "cpu", "--processes", "2", "--cell", "launch_floor", "--work-dir", str(tmp_path))
    assert result.returncode == 0, result.stderr[-3000:]
    record, summary = _lines(result.stdout)
    assert record["processes"] == 2 and len(record["samples"]) == 2
    assert record["spread"]["of"] == "per-process medians"
    assert sorted(os.listdir(tmp_path / "logs")) == ["launch_floor.0.log", "launch_floor.1.log"]
    assert list(summary["cells"]) == ["launch_floor"]


def test_without_cuda_exits_nonzero_and_prints_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    result = _script("--cell", "launch_floor", "--work-dir", str(tmp_path))
    assert result.returncode == 2
    assert result.stdout == ""


@pytest.mark.parametrize("name,sizes", chip_smoke.BENCH_CELLS)
def test_smoke_phase_10_sizes_fit_the_cells(name, sizes):
    assert name in chip_bench.CELLS
    inspect.signature(getattr(chip_bench, "cell_" + name)).bind("cuda", "work", **sizes)


# sha256 of each episode's src.wav, dst.wav and in.srt bytes, in that order,
# as chip_smoke.season_fixtures wrote the 12-episode season at 60 s with its
# jump at slot 5 before it took several slots
SEASON_60S = ["6012dc7d75b6b08a", "a72011c3c1598906", "b3c3b3c740415736", "dfdf072e4ade3d4e", "960412e8d3512195",
              "9913fa27a58d7e61", "107177824aa053b4", "15c30a07e2a8428d", "f11d46fae732ebec", "273feeb29e7c3b13",
              "1d511622b6dde57d", "45f8ae1040dce94f"]


@pytest.fixture(scope="module")
def season_digests(tmp_path_factory):
    """{slots: per-episode digests} of the 60 s season for phase 5's jump
    slots and for chip_bench's (whose first 12 episodes are phase 5's)."""
    digests = {}
    for slots in (chip_smoke.SEASON["jump_slots"], chip_bench.SEASON_JUMPS):
        fixtures = chip_smoke.season_fixtures(str(tmp_path_factory.mktemp("season")), 12, 60.0, slots)
        digests[slots] = []
        for paths, _ in fixtures:
            digest = hashlib.sha256()
            for path in paths:
                with open(path, "rb") as handle:
                    digest.update(handle.read())
            digests[slots].append(digest.hexdigest()[:16])
    return digests


@pytest.mark.parametrize("slots", [(5,), (5, 17)])
@pytest.mark.parametrize("episode", range(12))
def test_season_fixtures_byte_identical(season_digests, slots, episode):
    assert season_digests[slots][episode] == SEASON_60S[episode]
