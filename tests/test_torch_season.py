"""The port's season sync vs sushi_tpu's on the same inputs (CPU): the
written scripts must be byte-identical, to the JAX season's and to the
port's own single-episode CLI, and the errors must match."""

import filecmp
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sushi_tpu import season as jax_season  # noqa: E402
from sushi_tpu.text.subs import SrtScript  # noqa: E402
from sushi_tpu_torch import season as torch_season  # noqa: E402
from sushi_tpu_torch.cli import parse_args_and_run as torch_cli  # noqa: E402
from sushi_tpu_torch.errors import SushiError  # noqa: E402

from tests.fixtures import shift_audio, synth_episode, write_srt, write_wav_int16  # noqa: E402
from tests.test_season import EVENTS, fake_ffmpeg, season  # noqa: E402,F401  (fixtures)
from tests.test_torch_pipeline import _quiet  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jobs(module, specs, out_dir, tag):
    """``module.SeasonJob``s of ``specs`` (dicts of SeasonJob fields without
    ``output``), writing ``<out_dir>/<tag><i>.srt``."""
    return [
        module.SeasonJob(output=str(out_dir / ("%s%d.srt" % (tag, i))), **spec)
        for i, spec in enumerate(specs)
    ]


def _season_specs(season):
    _, jobs = season
    return [dict(src=j.src, dst=j.dst, script=j.script) for j in jobs]


def _noisy_pair(tmp_path, name, shift, seed, seconds=16.0):
    audio = synth_episode(seconds, EVENTS, seed=seed)
    rng = np.random.RandomState(seed + 5)
    dst_audio = shift_audio(audio, shift)
    dst_audio = (dst_audio.astype(np.int32) + rng.randint(-150, 150, len(dst_audio))).astype(np.int16)
    src = str(tmp_path / (name + ".src.wav"))
    script = str(tmp_path / (name + ".srt"))
    write_wav_int16(src, audio)
    write_srt(script, [(s, e, name + " line") for s, e in EVENTS])
    return src, dst_audio, script


def _container_specs(tmp_path):
    """Two jobs whose destinations are containers, demuxed through the
    PATH-shimmed ffmpeg (which copies ``<container>.hidden.wav``)."""
    specs = []
    for i, shift in enumerate((1.25, 2.0)):
        src, dst_audio, script = _noisy_pair(tmp_path, "ct%d" % i, shift, seed=80 + i)
        container = str(tmp_path / ("ct%d.dst.mkv" % i))
        with open(container, "w") as handle:
            handle.write("not really matroska")
        write_wav_int16(container[: -len(".mkv")] + ".hidden.wav", dst_audio)
        specs.append(dict(src=src, dst=container, script=script))
    return specs


def _keyframe_specs(tmp_path):
    """Two jobs with explicit keyframe logs and fps: the full
    post-processing, keyframe snapping included."""
    from tests.test_keyframes_e2e import write_scxvid_log

    fps = 24.0
    specs = []
    for i, shift in enumerate((2.505, 1.25)):
        src, dst_audio, script = _noisy_pair(tmp_path, "kf%d" % i, shift, seed=70 + i, seconds=18.0)
        dst = str(tmp_path / ("kf%d.dst.wav" % i))
        write_wav_int16(dst, dst_audio)
        src_kf = str(tmp_path / ("kf%d.src.kf.txt" % i))
        dst_kf = str(tmp_path / ("kf%d.dst.kf.txt" % i))
        write_scxvid_log(src_kf, [int(round(s * fps)) for s, _ in EVENTS], int(18 * fps))
        write_scxvid_log(dst_kf, [int(round((s + shift) * fps)) + 1 for s, _ in EVENTS], int(25 * fps))
        specs.append(dict(src=src, dst=dst, script=script, src_keyframes=src_kf,
                          dst_keyframes=dst_kf, src_fps=fps, dst_fps=fps))
    return specs


@pytest.mark.parametrize("case", ["wav", "no_grouping", "containers", "keyframes"])
def test_season_byte_identical_to_jax(case, season, fake_ffmpeg, tmp_path):  # noqa: F811
    options = {}
    if case in ("wav", "no_grouping"):
        specs = _season_specs(season)
        options["grouping"] = case == "wav"
    elif case == "containers":
        specs = _container_specs(tmp_path)
    else:
        specs = _keyframe_specs(tmp_path)
    written = {}
    for tag, module, extra in (("jax", jax_season, {}), ("torch", torch_season, {"device": "cpu"})):
        if case == "containers":
            options["temp_dir"] = str(tmp_path / ("work_" + tag))
        jobs = _jobs(module, specs, tmp_path, tag)
        assert module.sync_season(jobs, io_threads=2, **options, **extra) == []
        written[tag] = [job.output for job in jobs]
    for want, got in zip(written["jax"], written["torch"]):
        assert filecmp.cmp(want, got, shallow=False), (case, got)


def test_season_byte_identical_to_single_cli(season, tmp_path):  # noqa: F811
    jobs = _jobs(torch_season, _season_specs(season), tmp_path, "season")
    assert torch_season.sync_season(jobs, io_threads=3, device="cpu") == []
    for i, job in enumerate(jobs):
        single = str(tmp_path / ("single%d.srt" % i))
        _quiet(torch_cli, ["--src", job.src, "--dst", job.dst, "--script", job.script, "-o", single],
               device="cpu")
        assert filecmp.cmp(job.output, single, shallow=False), job.output


def test_broken_episode_skipped_with_exit_code_2_like_jax(season, tmp_path):  # noqa: F811
    """A corrupt source WAV fails its own episode only: both CLIs write the
    good episode (byte-identical) and exit 2."""
    specs = _season_specs(season)
    broken = tmp_path / "broken.src.wav"
    broken.write_bytes(b"RIFFgarbage-not-a-wav")
    entries = [dict(specs[0], src=str(broken)), specs[1]]
    outputs = {}
    for tag, main, extra in (("jax", jax_season.main, {}), ("torch", torch_season.main, {"device": "cpu"})):
        jobs_file = tmp_path / ("%s.jobs.json" % tag)
        outputs[tag] = [str(tmp_path / ("%s.bad.srt" % tag)), str(tmp_path / ("%s.good.srt" % tag))]
        jobs_file.write_text(json.dumps(
            [dict(entry, output=out) for entry, out in zip(entries, outputs[tag])]
        ), encoding="utf-8")
        with pytest.raises(SystemExit) as exited:
            _quiet(main, [str(jobs_file), "--io-threads", "2"], **extra)
        assert exited.value.code == 2, tag
        assert not os.path.exists(outputs[tag][0])
    assert filecmp.cmp(outputs["jax"][1], outputs["torch"][1], shallow=False)


@pytest.mark.parametrize("content", [json.dumps([{"src": "a"}]), "{}", "[]"])
def test_load_jobs_validation_like_jax(tmp_path, content):
    path = tmp_path / "jobs.json"
    path.write_text(content, encoding="utf-8")
    messages = []
    for module in (jax_season, torch_season):
        with pytest.raises(module.SushiError) as raised:
            module.load_jobs(str(path))
        messages.append(str(raised.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize(
    "fields",
    [
        dict(src_timecodes="<script>", src_fps=23.976),  # the fps/timecodes conflict
        dict(src_keyframes="auto", dst_keyframes="auto", src_fps=24.0, dst_fps=24.0),
        dict(src_keyframes="make", dst_keyframes="make", src_fps=24.0, dst_fps=24.0),
        dict(src_keyframes="<script>"),  # one-sided keyframes
        dict(src_keyframes="<script>", dst_keyframes="<script>"),  # keyframes without fps
        dict(chapters_file="<missing>"),
    ],
)
def test_job_option_errors_like_jax(season, tmp_path, fields):  # noqa: F811
    spec = _season_specs(season)[0]
    stand_ins = {"<script>": spec["script"], "<missing>": str(tmp_path / "missing.xml")}
    fields = {key: stand_ins.get(value, value) for key, value in fields.items()}
    messages = []
    for module, extra in ((jax_season, {}), (torch_season, {"device": "cpu"})):
        job = module.SeasonJob(output=str(tmp_path / "x.srt"), **spec, **fields)
        with pytest.raises(module.SushiError) as raised:
            module.sync_season([job], **extra)
        messages.append(str(raised.value))
    assert messages[0] == messages[1]
    assert not os.path.exists(tmp_path / "x.srt")


def test_shared_container_demuxed_once(tmp_path, fake_ffmpeg):  # noqa: F811
    """Two jobs sharing one destination container demux it exactly once."""
    src, dst_audio, _ = _noisy_pair(tmp_path, "movie", 2.0, seed=95)
    container = str(tmp_path / "movie.mkv")
    with open(container, "w") as handle:
        handle.write("not really matroska")
    write_wav_int16(container[: -len(".mkv")] + ".hidden.wav", dst_audio)
    specs = []
    for i in range(2):
        script = str(tmp_path / ("rev%d.srt" % i))
        write_srt(script, [(s, e, "rev%d line" % i) for s, e in EVENTS])
        specs.append(dict(src=src, dst=container, script=script))
    jobs = _jobs(torch_season, specs, tmp_path, "rev")
    assert torch_season.sync_season(jobs, temp_dir=str(tmp_path / "work"), io_threads=2, device="cpu") == []
    demuxes = [line for line in (fake_ffmpeg / "demux.log").read_text().splitlines() if container in line]
    assert len(demuxes) == 1, demuxes
    for job in jobs:
        for event, (start, _) in zip(SrtScript.from_file(job.output).events, EVENTS):
            assert event.start == pytest.approx(start + 2.0, abs=2e-3), job.output


def test_rounds_merge_episodes(season, tmp_path, monkeypatch):  # noqa: F811
    """Episodes that finish ingest together share device rounds: some
    ``execute_planned_multi`` call carries items of two or more pairs.
    A barrier releases the three ingests at once."""
    barrier = threading.Barrier(3, timeout=120)
    prepare = torch_season._prepare_episode

    def prepare_together(*args, **kwargs):
        episode = prepare(*args, **kwargs)
        barrier.wait()
        return episode

    pairs_per_round = []
    execute = torch_season.execute_planned_multi

    def recording(items, *args, **kwargs):
        pairs_per_round.append(len({id(pair) for pair, _ in items}))
        return execute(items, *args, **kwargs)

    monkeypatch.setattr(torch_season, "_prepare_episode", prepare_together)
    monkeypatch.setattr(torch_season, "execute_planned_multi", recording)
    jobs = _jobs(torch_season, _season_specs(season), tmp_path, "merged")
    assert torch_season.sync_season(jobs, io_threads=3, device="cpu") == []
    assert max(pairs_per_round) >= 2, pairs_per_round


def test_default_device_without_cuda_raises(season, tmp_path, monkeypatch):  # noqa: F811
    """device=None means CUDA; without it the season fails loudly instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = _jobs(torch_season, _season_specs(season), tmp_path, "nocuda")
    with pytest.raises(SushiError, match="CUDA"):
        torch_season.sync_season(jobs)
    assert not any(os.path.exists(job.output) for job in jobs)


def _jobs_file(season, tmp_path):  # noqa: F811
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps([
        dict(spec, output=str(tmp_path / ("sub%d.srt" % i)))
        for i, spec in enumerate(_season_specs(season))
    ]), encoding="utf-8")
    return str(path)


def test_season_never_imports_jax(season, tmp_path):  # noqa: F811
    """A season run leaves JAX and every ``sushi_tpu`` module unimported.  A
    subprocess, because this test process imported both already."""
    code = textwrap.dedent(
        """
        import sys
        from sushi_tpu_torch.season import load_jobs, sync_season
        def reference_modules():
            return sorted(m for m in sys.modules if m == "sushi_tpu" or m.startswith("sushi_tpu."))
        assert "jax" not in sys.modules, "importing the season imported jax"
        assert not reference_modules(), "importing the season imported %s" % reference_modules()
        assert sync_season(load_jobs(sys.argv[1]), device="cpu") == []
        assert "jax" not in sys.modules, "the season imported jax"
        assert not reference_modules(), "the season imported %s" % reference_modules()
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, SUSHI_STREAM_CACHE=str(tmp_path / "cache"))
    result = subprocess.run([sys.executable, "-c", code, _jobs_file(season, tmp_path)],
                            env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    assert all(os.path.getsize(tmp_path / ("sub%d.srt" % i)) > 0 for i in range(3))


def test_season_module_without_cuda_exits_nonzero(season, tmp_path):  # noqa: F811
    """``python -m sushi_tpu_torch.season`` with no visible CUDA device
    exits 2 with a message and writes nothing."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, "-m", "sushi_tpu_torch.season", _jobs_file(season, tmp_path)],
                            env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 2, result.stderr[-3000:]
    assert "CUDA" in result.stderr
    assert not any((tmp_path / ("sub%d.srt" % i)).exists() for i in range(3))


@pytest.mark.cuda
def test_cuda_season_byte_identical_to_cpu(season, tmp_path):  # noqa: F811
    """On the card the 3-episode season writes what the CPU run writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only on the card)")
    from sushi_tpu_torch.ops import coarse, rescore

    specs = _season_specs(season)
    want = _jobs(torch_season, specs, tmp_path, "cpu")
    assert torch_season.sync_season(want, io_threads=3, device="cpu") == []
    launches = (rescore.rescore_candidates.launches, coarse.coarse_post.launches)
    got = _jobs(torch_season, specs, tmp_path, "cuda")
    assert torch_season.sync_season(got, io_threads=3) == []
    assert rescore.rescore_candidates.launches > launches[0]
    assert coarse.coarse_post.launches > launches[1]
    for cpu_job, cuda_job in zip(want, got):
        assert filecmp.cmp(cpu_job.output, cuda_job.output, shallow=False), cuda_job.output
