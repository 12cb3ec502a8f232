"""The ``season`` entry: pass k is one ``sushi_tpu_torch.season.sync_season``
call over every episode with its script ``k mod scripts``, as the season
CLI runs it; each pass is timed from the call to its return, after every
script is written."""

import contextlib
import logging
import os
import time

from perfbench.entries import read_text, remove

_log = logging.getLogger("perfbench")


class Capture:
    """Keeps what the program's search returned for each episode: wraps the
    season's finishing of an episode and ``SearchSession.finalize``."""

    def __init__(self):
        from sushi_tpu_torch import season
        from sushi_tpu_torch.align.batcher import SearchSession

        self.results = None
        self.by_episode = {}
        self._patched = [(season, "_finish_episode"), (SearchSession, "finalize")]
        finish_episode, finalize = [getattr(owner, name) for owner, name in self._patched]
        self._saved = [finish_episode, finalize]

        def kept_finish(episode, *args, **kwargs):
            self.results = None
            finish_episode(episode, *args, **kwargs)
            self.by_episode[episode.index] = self.results

        def kept_finalize(session):
            self.results = finalize(session)
            return self.results

        self._wrappers = [kept_finish, kept_finalize]

    def __enter__(self):
        for (owner, name), wrapper in zip(self._patched, self._wrappers):
            setattr(owner, name, wrapper)
        return self

    def __exit__(self, *exc):
        for (owner, name), saved in zip(self._patched, self._saved):
            setattr(owner, name, saved)


class Entry:
    def __init__(self, config, manifest, out_dir, device):
        from sushi_tpu_torch.season import SeasonJob

        self.config, self.device = config, device
        self.capture = Capture()
        scripts = len(manifest["episodes"][0]["scripts"])
        self.passes = []
        for s in range(scripts):
            jobs = []
            for e, episode in enumerate(manifest["episodes"]):
                out = os.path.join(out_dir, "ep%02d_script%02d.srt" % (e, s))
                jobs.append(dict(key=(e, s), out=out, events=episode["scripts"][s]["events"],
                                 job=SeasonJob(src=episode["src"], dst=episode["dst"],
                                               script=episode["scripts"][s]["path"], output=out)))
            self.passes.append(jobs)
        self.pool = len(self.passes)

    def warm(self):
        """The cold first pass and one pass of every other script set;
        returns the cold pass's seconds."""
        started = time.perf_counter()
        self.step(0, {})
        cold = time.perf_counter() - started
        for index in range(1, len(self.passes)):
            self.step(index, {})
        return cold

    def step(self, index, seen, span=contextlib.nullcontext):
        """One pass; adds each episode's search results and written script
        to ``seen`` under its (episode, script) key."""
        from sushi_tpu_torch.season import sync_season

        jobs = self.passes[index % len(self.passes)]
        config, capture = self.config, self.capture
        for job in jobs:
            remove(job["out"])
        capture.by_episode.clear()
        started = time.perf_counter()
        with span():
            try:
                failures = len(sync_season(
                    [job["job"] for job in jobs], sample_rate=config["sample_rate"],
                    sample_type=config["sample_type"], window=config["window"], max_window=config["max_window"],
                    rewind_thresh=config["rewind_thresh"], smooth_radius=config["smooth_radius"],
                    max_ts_duration=config["max_ts_duration"], max_ts_distance=config["max_ts_distance"],
                    io_threads=config["io_threads"], grouping=config["grouping"], device=self.device))
            except Exception as error:  # a failed pass counts, and the run goes on
                _log.error("season pass failed: %s", error)
                failures = len(jobs)
        took = time.perf_counter() - started
        missing = 0
        for e, job in enumerate(jobs):
            written = read_text(job["out"])
            if written is None or capture.by_episode.get(e) is None:
                missing += 1
                continue
            entry = seen.setdefault(job["key"], {"groups": set(), "outputs": set()})
            entry["groups"].add(tuple((r.shift, r.diff) for r in capture.by_episode[e]))
            entry["outputs"].add(written)
        return dict(seconds=took, events=sum(job["events"] for job in jobs), attempted=len(jobs),
                    failed=max(failures, missing))

    @staticmethod
    def metrics(steps, window):
        """The entry's end-to-end metrics, and what the readers count by."""
        episodes = sum(step["attempted"] for step in steps)
        return {"episodes_per_min": episodes * 60.0 / window}, {"passes": len(steps)}
