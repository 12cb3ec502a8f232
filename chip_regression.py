#!/usr/bin/env python3
"""End-to-end regression harness of the PyTorch + CUDA port.

    python3 chip_regression.py --make-fixtures build/chip_regression
    python3 chip_regression.py build/chip_regression/regression.json [--only NAME] [--device cpu]

The port of ``tools/regression.py``: a JSON config names CLI runs, each
compared frame-accurately against a hand-verified "ideal" script with an
EXACT expected count of differing lines (a regression and a silent change
of behaviour both fail), season runs compared the same way job by job,
and WAV-load budgets (host CPU seconds and RSS growth of the port's
decoder).  ``--make-fixtures DIR`` synthesizes the same media, scripts,
ideals and config as ``tools/regression.py --make-fixtures``, byte for
byte: a 300 s episode, its copy delayed by 2.505 s, and a copy with a 15 s
insertion near 150 s.

Each CLI test runs ``python -m sushi_tpu_torch`` in a subprocess, and the
season test ``python -m sushi_tpu_torch.season``, as users run them; both
need a CUDA device.  With ``--device cpu`` the same argv runs in this
process on the plain PyTorch path (``cli.parse_args_and_run`` and
``season.main`` with ``device="cpu"``).  Exit code 1 means a test failed.
Imports nothing of JAX.
"""

import argparse
import json
import logging
import os
import resource
import subprocess
import sys
import time

from chip_smoke import _dropping_new_log_handlers, media_fixtures, write_ass, write_srt

REPO = os.path.dirname(os.path.abspath(__file__))

_log = logging.getLogger("chip_regression")


def compare_scripts(ideal_path, output_path, fps):
    """Frame-accurate line diff; returns the number of mismatching events."""
    from sushi_tpu_torch.media.timecodes import Timecodes
    from sushi_tpu_torch.text.subs import load_script

    timecodes = Timecodes.cfr(fps)
    ideal = load_script(ideal_path).events
    produced = load_script(output_path).events
    if len(ideal) != len(produced):
        _log.error("event count mismatch: ideal %d vs output %d", len(ideal), len(produced))
        return abs(len(ideal) - len(produced)) + len(ideal)
    failures = 0
    for idx, (a, b) in enumerate(zip(ideal, produced)):
        same_start = timecodes.get_frame_number(a.start) == timecodes.get_frame_number(b.start)
        same_end = timecodes.get_frame_number(a.end) == timecodes.get_frame_number(b.end)
        if not (same_start and same_end):
            failures += 1
            if failures <= 10:
                _log.info("  line %d: ideal %.3f-%.3f vs output %.3f-%.3f", idx, a.start, a.end, b.start, b.end)
    return failures


def run_entry(module, argv, device):
    """``python -m <module> <argv>``: a subprocess when ``device`` is None
    (CUDA), else in this process on ``device``.  Returns the exit code and
    the tail of the error output."""
    if device is None:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        result = subprocess.run([sys.executable, "-m", module] + argv, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True, env=env)
        return result.returncode, result.stderr[-2000:]
    from sushi_tpu_torch import SushiError, season
    from sushi_tpu_torch.cli import parse_args_and_run

    try:
        with _dropping_new_log_handlers():
            if module == "sushi_tpu_torch.season":
                season.main(argv, device=device)
            else:
                parse_args_and_run(argv, device=device)
    except SushiError as error:
        return 2, str(error)
    except SystemExit as exited:
        return exited.code, ""
    return 0, ""


def run_test(test, base, device=None):
    name = test["name"]
    out_path = os.path.join(base, name + ".out" + os.path.splitext(test["script"])[1])
    argv = [
        "--src", os.path.join(base, test["src"]),
        "--dst", os.path.join(base, test["dst"]),
        "--script", os.path.join(base, test["script"]),
        "-o", out_path,
    ] + test.get("extra_args", [])
    _log.info("[%s] %s", name, " ".join(argv))
    started = time.time()
    code, error = run_entry("sushi_tpu_torch", argv, device)
    elapsed = time.time() - started
    if code != 0:
        _log.error("[%s] FAILED: exit code %s %s", name, code, error)
        return False
    failures = compare_scripts(os.path.join(base, test["ideal"]), out_path, test.get("fps", 23.976))
    expected = test.get("expected_errors", 0)
    if failures != expected:
        _log.error("[%s] FAILED: %d line errors, expected exactly %d", name, failures, expected)
        return False
    max_time = test.get("max_time")
    if max_time and elapsed > max_time:
        _log.error("[%s] FAILED: took %.2fs, budget %.2fs", name, elapsed, max_time)
        return False
    _log.info("[%s] ok: %d expected line errors, %.2fs", name, failures, elapsed)
    return True


def run_season_test(test, base, device=None):
    """One season run over several jobs, each output compared
    frame-accurately against its ideal with an exact error count."""
    name = test["name"]
    jobs = [
        {
            "src": os.path.join(base, job["src"]),
            "dst": os.path.join(base, job["dst"]),
            "script": os.path.join(base, job["script"]),
            "output": os.path.join(base, "%s.out%d%s" % (name, i, os.path.splitext(job["script"])[1])),
        }
        for i, job in enumerate(test["jobs"])
    ]
    jobs_path = os.path.join(base, name + ".jobs.json")
    with open(jobs_path, "w", encoding="utf-8") as handle:
        json.dump(jobs, handle)
    argv = [jobs_path] + test.get("extra_args", [])
    _log.info("[%s] %s", name, " ".join(argv))
    started = time.time()
    code, error = run_entry("sushi_tpu_torch.season", argv, device)
    elapsed = time.time() - started
    if code != 0:
        _log.error("[%s] FAILED: exit code %s %s", name, code, error)
        return False
    ok = True
    for job_cfg, job in zip(test["jobs"], jobs):
        failures = compare_scripts(os.path.join(base, job_cfg["ideal"]), job["output"], test.get("fps", 23.976))
        expected = job_cfg.get("expected_errors", 0)
        if failures != expected:
            _log.error("[%s] FAILED on %s: %d line errors, expected exactly %d",
                       name, job_cfg["src"], failures, expected)
            ok = False
    if ok:
        _log.info("[%s] ok: %d jobs, %.2fs", name, len(jobs), elapsed)
    return ok


def run_wav_test(test, base):
    """The port's WAV decode against host budgets: CPU seconds and growth
    of this process's peak RSS (host numbers, not device numbers)."""
    from sushi_tpu_torch.media.stream import AudioStream

    name = test["name"]
    usage_before = resource.getrusage(resource.RUSAGE_SELF)
    started = time.time()
    AudioStream(os.path.join(base, test["path"]), test.get("sample_rate", 12000), "uint8")
    elapsed = time.time() - started
    usage_after = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (usage_after.ru_utime + usage_after.ru_stime) - (usage_before.ru_utime + usage_before.ru_stime)
    rss_delta_mb = (usage_after.ru_maxrss - usage_before.ru_maxrss) / 1024.0

    ok = True
    if test.get("max_time") and cpu > test["max_time"]:
        _log.error("[%s] FAILED: %.2fs CPU, budget %.2fs", name, cpu, test["max_time"])
        ok = False
    if test.get("max_memory") and rss_delta_mb > test["max_memory"]:
        _log.error("[%s] FAILED: %.1f MB RSS delta, budget %s MB", name, rss_delta_mb, test["max_memory"])
        ok = False
    if ok:
        _log.info("[%s] ok: %.2fs wall, %.2fs CPU, %.1f MB RSS delta", name, elapsed, cpu, rss_delta_mb)
    return ok


def make_fixtures(base):
    """Synthesize the default regression media set with known-true shifts,
    byte for byte as ``tools/regression.py --make-fixtures`` does; returns
    the config's path."""
    import numpy as np

    from sushi_tpu_torch.text.subs import load_script

    fixtures = media_fixtures()
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(99)
    events = []
    cursor = 2.0
    while cursor < 290.0:
        duration = 1.0 + rng.rand() * 2.5
        events.append((cursor, cursor + duration))
        cursor += duration + 0.7 + rng.rand() * 1.5

    shift = 2.505
    audio = fixtures.synth_episode(300.0, events, seed=17)
    dst_audio = fixtures.shift_audio(audio, shift)
    dst_audio = (dst_audio.astype(np.int32) + rng.randint(-150, 150, len(dst_audio))).astype(np.int16)
    fixtures.write_wav_int16(os.path.join(base, "ep.src.wav"), audio)
    fixtures.write_wav_int16(os.path.join(base, "ep.dst.wav"), dst_audio)

    # a second destination with a 15 s insertion near 150 s: exercises the
    # window-escalation/rewind recovery path end to end.  The insertion
    # lands mid-gap between two events so no line straddles the cut.
    gap_index = next(i for i, (s, _) in enumerate(events) if s > 150.0)
    cut_time = (events[gap_index - 1][1] + events[gap_index][0]) / 2.0
    jump_at = int((cut_time + shift) * 48000)
    insertion = rng.randint(-300, 300, 15 * 48000).astype(np.int16)
    jump_audio = np.concatenate([dst_audio[:jump_at], insertion, dst_audio[jump_at:]])
    fixtures.write_wav_int16(os.path.join(base, "ep.jump.wav"), jump_audio)

    lines = [(s, e, "line %d" % i) for i, (s, e) in enumerate(events)]
    write_srt(os.path.join(base, "ep.srt"), lines)
    write_ass(os.path.join(base, "ep.ass"), lines)
    # ideals derive from the ROUND-TRIPPED inputs (scripts quantize times to
    # their format precision), shifted by the known-true amount
    for ext in (".srt", ".ass"):
        script = load_script(os.path.join(base, "ep" + ext))
        for event in script.events:
            event.set_shift(shift, 0.0)
            event.apply_shift()
        script.save_to_file(os.path.join(base, "ep.ideal" + ext))

    # jump ideal: +15 s extra after the insertion point
    script = load_script(os.path.join(base, "ep.srt"))
    for event in script.events:
        event.set_shift(shift + (15.0 if event.start >= cut_time else 0.0), 0.0)
        event.apply_shift()
    script.save_to_file(os.path.join(base, "ep.jump.ideal.srt"))

    config = {
        "tests": [
            {"name": "srt-uniform-shift", "src": "ep.src.wav", "dst": "ep.dst.wav",
             "script": "ep.srt", "ideal": "ep.ideal.srt", "expected_errors": 0, "fps": 23.976},
            # 3 stable line "errors": ASS centisecond quantization puts
            # round(x)+shift vs round(x+shift) on opposite sides of a frame
            # boundary for 3 of the ~110 lines — the exact-count contract
            # (like the reference's expected_errors: 84) catches changes
            {"name": "ass-uniform-shift", "src": "ep.src.wav", "dst": "ep.dst.wav",
             "script": "ep.ass", "ideal": "ep.ideal.ass", "expected_errors": 3, "fps": 23.976},
            {"name": "srt-no-grouping", "src": "ep.src.wav", "dst": "ep.dst.wav",
             "script": "ep.srt", "ideal": "ep.ideal.srt", "expected_errors": 0,
             "fps": 23.976, "extra_args": ["--no-grouping"]},
            {"name": "srt-15s-jump-recovery", "src": "ep.src.wav", "dst": "ep.jump.wav",
             "script": "ep.srt", "ideal": "ep.jump.ideal.srt", "expected_errors": 0,
             "fps": 23.976},
        ],
        "season_tests": [
            # both fixture episodes as one batch: the uniform shift and the
            # 15s-jump recovery must survive merged device rounds
            {"name": "season-batch", "fps": 23.976, "jobs": [
                {"src": "ep.src.wav", "dst": "ep.dst.wav", "script": "ep.srt",
                 "ideal": "ep.ideal.srt", "expected_errors": 0},
                {"src": "ep.src.wav", "dst": "ep.jump.wav", "script": "ep.srt",
                 "ideal": "ep.jump.ideal.srt", "expected_errors": 0},
            ]},
        ],
        "wav_tests": [
            {"name": "wav-load-budget", "path": "ep.src.wav", "max_time": 0.7, "max_memory": 120}
        ],
    }
    config_path = os.path.join(base, "regression.json")
    with open(config_path, "w", encoding="utf-8") as handle:
        json.dump(config, handle, indent=2)
    _log.info("fixtures written to %s", base)
    return config_path


def run_config(config_path, device=None, only=None):
    """Every test of the config (or the one named ``only``); returns the
    names of those that failed."""
    with open(config_path, encoding="utf-8") as handle:
        config = json.load(handle)
    base = os.path.dirname(os.path.abspath(config_path))
    failed = []
    for kind, run in (("tests", lambda t: run_test(t, base, device)),
                      ("season_tests", lambda t: run_season_test(t, base, device)),
                      # budgets of this process's rusage: serial, last
                      ("wav_tests", lambda t: run_wav_test(t, base))):
        for test in config.get(kind, []):
            if (not only or test["name"] == only) and not run(test):
                failed.append(test["name"])
    return failed


def main(argv=None):
    parser = argparse.ArgumentParser(description="sushi-tpu-torch end-to-end regression harness")
    parser.add_argument("config", nargs="?", help="regression.json path")
    parser.add_argument("--make-fixtures", metavar="DIR", help="synthesize default fixtures into DIR")
    parser.add_argument("--only", default=None, help="run only the named test")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cpu: run every test in this process on the plain path (tests only)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logging.getLogger("sushi_tpu").setLevel(logging.WARNING)  # the port's own log, in-process runs

    config_path = args.config
    if args.make_fixtures:
        config_path = make_fixtures(args.make_fixtures)
        if not args.config:
            _log.info("now run: python3 chip_regression.py %s", config_path)
            return 0
    if not config_path:
        parser.error("config path required (or use --make-fixtures)")

    failed = run_config(config_path, device=None if args.device == "cuda" else args.device, only=args.only)
    if failed:
        _log.error("FAILED: %s", ", ".join(failed))
        return 1
    _log.info("all regression tests passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
