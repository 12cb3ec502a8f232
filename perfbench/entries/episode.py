"""The ``episode`` entry: step k is one ``sushi_tpu_torch.pipeline.run``
call, with the flags as the CLI's own parser reads them, of the first
episode's script ``k mod scripts`` against the episode's memoized audio
pair; each step is timed from the call to its return, after the script is
written."""

import contextlib
import logging
import os
import time

from perfbench.entries import read_text, remove

_log = logging.getLogger("perfbench")


class Capture:
    """Keeps what the program's search returned for the last sync: wraps
    ``SearchSession.finalize`` (one session a sync)."""

    def __init__(self):
        from sushi_tpu_torch.align.batcher import SearchSession

        self.results = None
        self._owner, self._saved = SearchSession, SearchSession.finalize
        finalize = self._saved

        def kept_finalize(session):
            self.results = finalize(session)
            return self.results

        self._wrapper = kept_finalize

    def __enter__(self):
        self._owner.finalize = self._wrapper
        return self

    def __exit__(self, *exc):
        self._owner.finalize = self._saved


def _flags(config, src, dst, script, out):
    """The CLI's flags for one sync of ``script`` under ``config``."""
    argv = ["--src", src, "--dst", dst, "--script", script, "-o", out,
            "--sample-rate", str(config["sample_rate"]), "--sample-type", config["sample_type"],
            "--window", str(config["window"]), "--max-window", str(config["max_window"]),
            "--rewind-thresh", str(config["rewind_thresh"]), "--smooth-radius", str(config["smooth_radius"]),
            "--max-ts-duration", repr(config["max_ts_duration"]),
            "--max-ts-distance", repr(config["max_ts_distance"])]
    return argv if config["grouping"] else argv + ["--no-grouping"]


class Entry:
    def __init__(self, config, manifest, out_dir, device):
        from sushi_tpu_torch.cli import create_arg_parser

        self.device = device
        self.capture = Capture()
        episode = manifest["episodes"][0]
        self.jobs = []
        for s, script in enumerate(episode["scripts"]):
            out = os.path.join(out_dir, "ep00_script%02d.srt" % s)
            args = create_arg_parser().parse_args(_flags(config, episode["src"], episode["dst"], script["path"], out))
            self.jobs.append(dict(key=(0, s), out=out, events=script["events"], args=args))
        self.pool = len(self.jobs)

    def warm(self):
        """The cold first sync (decode, upload, seed) and one sync of every
        other script; returns the cold sync's seconds."""
        started = time.perf_counter()
        self.step(0, {})
        cold = time.perf_counter() - started
        for index in range(1, self.pool):
            self.step(index, {})
        return cold

    def step(self, index, seen, span=contextlib.nullcontext):
        """One sync; adds its search results and written script to ``seen``
        under its (episode, script) key."""
        from sushi_tpu_torch.pipeline import run

        job, capture = self.jobs[index % self.pool], self.capture
        remove(job["out"])
        capture.results = None
        failed = 0
        started = time.perf_counter()
        with span():
            try:
                run(job["args"], device=self.device)
            except Exception as error:  # a failed sync counts, and the run goes on
                _log.error("sync failed: %s", error)
                failed = 1
        took = time.perf_counter() - started
        written = read_text(job["out"])
        if written is None or capture.results is None:
            failed = 1
        else:
            entry = seen.setdefault(job["key"], {"groups": set(), "outputs": set()})
            entry["groups"].add(tuple((r.shift, r.diff) for r in capture.results))
            entry["outputs"].add(written)
        return dict(seconds=took, events=job["events"], attempted=1, failed=failed)

    @staticmethod
    def metrics(steps, window):
        """The entry's end-to-end metrics (a sync is one episode's script),
        and what the readers count by."""
        return {"episodes_per_min": len(steps) * 60.0 / window}, {"syncs": len(steps)}
