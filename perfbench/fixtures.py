"""The generator of every cell's inputs: audio pairs and scripts from a seed.

One general generator reads a configuration (episode length, WAV rate,
episodes) and a traffic mix (a data file of parameters) and writes, for
each episode, a source WAV, a destination WAV and a pool of SRT scripts.
The recipe is that of the repository's synthetic fixtures: "dialogue"
bursts of noise and a 120-820 Hz tone on a faint bed, 16-bit mono PCM,
with the bursts' noise low-passed by a moving average; the destination is the
source delayed by a base shift of any length (a fraction of a sample by
linear interpolation) with independent noise, and a mix may insert
bed-level noise spans at event boundaries (scenes the other release
lacks).

Sizes and edits are fixed by the files and only values by the seed:
every seed gets the same event counts (in another order), the same edits
at the same places, and its own audio, base shift, script lines and
jitter.  (Where the edits sit decides how much the program's speculative
replay re-searches, by a factor of four between seeds when they were
drawn.)  Traffic keys (each per-episode list is cycled over the
episodes):

- ``base_events``: dialogue bursts in the audio; ``tone_hz``: the range
  of the tone in each burst; ``noise_lowpass_hz``: the first null of the
  moving average that low-passes the bursts' noise;
- ``event_seconds``, ``gap_seconds``: ranges of a burst and of a gap,
  drawn uniformly (the timeline is then stretched to fill the episode);
- ``scripts_per_episode``, ``script_events``: the pool, whose counts
  are spread evenly over the range; each script keeps that many of the
  bursts and moves each boundary by up to ``jitter_seconds``;
- ``shift_seconds``: range of the base shift's magnitude (sign from the
  seed), not rounded to any sample grid;
- ``inserts``: per episode, [place, seconds] of each inserted span, the
  place a fraction of the timeline's events (the span goes in the gap
  before that event);
- ``dst_noise``, ``insert_noise``: their amplitudes.

Files are cached under a directory keyed by the recipe and the seed; only
the newest key of each configuration is kept.
"""

import hashlib
import json
import math
import os
import shutil
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from perfbench.reference.script import format_time

VERSION = 2
LEAD_SECONDS = 10.0  # no event before this, none in the last as many seconds


def _rng(seed, *stream):
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *stream]))


def write_wav(path, samples, framerate):
    payload = np.asarray(samples, np.int16).astype("<i2").tobytes()
    fmt = struct.pack("<HHLLHH", 1, 1, framerate, framerate * 2, 2, 16)
    with open(path, "wb") as handle:
        handle.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE")
        handle.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        handle.write(b"data" + struct.pack("<I", len(payload)) + payload)


def write_srt(path, events):
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("\n\n".join("%d\n%s --> %s\n%s" % (i + 1, format_time(s), format_time(e), text)
                                 for i, (s, e, text) in enumerate(events)))


def timeline(rng, traffic, seconds):
    """(start, end) of each burst, stretched to fill the episode."""
    count = traffic["base_events"]
    durations = rng.uniform(*traffic["event_seconds"], size=count)
    gaps = rng.uniform(*traffic["gap_seconds"], size=count)
    starts = np.concatenate([[0.0], np.cumsum(durations + gaps)[:-1]])
    scale = (seconds - 2 * LEAD_SECONDS) / (starts[-1] + durations[-1])
    return [(LEAD_SECONDS + s * scale, LEAD_SECONDS + (s + d) * scale) for s, d in zip(starts, durations)]


def synth_audio(rng, seconds, events, framerate, tone_hz, lowpass_hz, amplitude=9000, bed=400):
    """Bursts of noise and a tone at each event over a faint noise bed; the
    tone's frequency is picked in ``tone_hz`` by the burst's position, and
    the noise is a moving average of white noise whose first null is at
    ``lowpass_hz``, scaled back to the white noise's power."""
    low, high = tone_hz
    taps = max(1, int(round(framerate / lowpass_hz)))
    total = int(round(seconds * framerate))
    audio = rng.integers(-bed, bed, size=total).astype(np.float32)
    for start, end in events:
        a, b = max(0, int(start * framerate)), min(total, int(end * framerate))
        t = np.arange(b - a, dtype=np.float32)
        white = np.cumsum(rng.standard_normal(b - a + taps, dtype=np.float32), dtype=np.float64)
        burst = ((white[taps:] - white[:-taps]) * (amplitude * 0.3 / np.sqrt(taps))).astype(np.float32)
        burst += np.float32(amplitude * 0.5) * np.sin(t * np.float32(2 * np.pi * (low + a % (high - low)) / framerate))
        audio[a:b] += burst
    return np.clip(audio, -32767, 32767).astype(np.int16)


def delay(samples, shift, framerate):
    """``samples`` later by ``shift`` seconds (earlier where negative): the
    whole samples by padding or cutting the start, the fraction left by
    linear interpolation between neighbours."""
    whole = math.floor(shift * framerate)
    fraction = np.float32(shift * framerate - whole)
    x = samples.astype(np.float32)
    moved = (1 - fraction) * x
    moved[1:] += fraction * x[:-1]
    return np.concatenate([np.zeros(whole, np.float32), moved]) if whole >= 0 else moved[-whole:]


def episode(directory, rng, config, traffic, index):
    """Writes one episode's WAV pair and script pool; returns its manifest."""
    seconds, rate = config["episode_seconds"], config["wav_rate"]
    events = timeline(rng, traffic, seconds)
    src = synth_audio(rng, seconds, events, rate, traffic["tone_hz"], traffic["noise_lowpass_hz"])

    shift = float(rng.uniform(*traffic["shift_seconds"]) * rng.choice([-1.0, 1.0]))
    dst = delay(src, shift, rate)
    dst += rng.integers(-traffic["dst_noise"], traffic["dst_noise"], size=len(dst)).astype(np.float32)
    dst = np.clip(np.round(dst), -32767, 32767).astype(np.int16)

    inserts = traffic["inserts"][index % len(traffic["inserts"])]

    def site(fraction):
        return min(max(1, int(round(fraction * len(events)))), len(events) - 1)

    # inserted spans in the gap before the event at each site, latest first
    # so that each cut lands where the source timeline puts it
    for fraction, length in sorted(inserts, reverse=True):
        at = site(fraction)
        cut = int(((events[at - 1][1] + events[at][0]) / 2 + shift) * rate)
        span = rng.integers(-traffic["insert_noise"], traffic["insert_noise"], size=int(length * rate))
        dst = np.concatenate([dst[:cut], span.astype(np.int16), dst[cut:]])

    paths = {"src": "ep%02d_src.wav" % index, "dst": "ep%02d_dst.wav" % index}
    write_wav(os.path.join(directory, paths["src"]), src, rate)
    write_wav(os.path.join(directory, paths["dst"]), dst, rate)

    pool = traffic["scripts_per_episode"]
    low, high = traffic["script_events"]
    counts = rng.permutation(np.round(np.linspace(low, high, pool)).astype(int) if pool > 1 else [(low + high) // 2])
    jitter = traffic["jitter_seconds"]
    scripts = []
    for number, count in enumerate(counts):
        kept = np.sort(rng.choice(len(events), size=int(count), replace=False))
        moves = rng.uniform(-jitter, jitter, size=(len(kept), 2))
        lines = [(events[k][0] + ds, events[k][1] + de, "script %d line %d" % (number, i))
                 for i, (k, (ds, de)) in enumerate(zip(kept, moves))]
        name = "ep%02d_script%02d.srt" % (index, number)
        write_srt(os.path.join(directory, name), lines)
        scripts.append({"path": name, "events": len(lines)})
    return dict(paths, scripts=scripts, shift=shift, inserts=inserts)


def fixtures(cache_root, config, traffic, seed):
    """The cell's inputs for ``seed``: {"episodes": [{"src", "dst", "scripts":
    [{"path", "events"}], ...}]} with absolute paths, written unless cached."""
    recipe = json.dumps({"version": VERSION, "config": config, "traffic": traffic, "seed": seed}, sort_keys=True)
    key = hashlib.sha256(recipe.encode()).hexdigest()[:20]
    config_dir = os.path.join(cache_root, config["name"])
    directory = os.path.join(config_dir, key)
    manifest_path = os.path.join(directory, "manifest.json")
    if not os.path.exists(manifest_path):
        shutil.rmtree(config_dir, ignore_errors=True)
        os.makedirs(directory)
        with ThreadPoolExecutor(max_workers=4) as pool:
            made = pool.map(lambda index: episode(directory, _rng(seed, index), config, traffic, index),
                            range(config["episodes"]))
            manifest = {"episodes": list(made)}
        with open(manifest_path + ".part", "w", encoding="utf-8") as handle:
            json.dump(manifest, handle)
        os.replace(manifest_path + ".part", manifest_path)
    with open(manifest_path, encoding="utf-8") as handle:
        manifest = json.load(handle)
    for ep in manifest["episodes"]:
        ep["src"], ep["dst"] = os.path.join(directory, ep["src"]), os.path.join(directory, ep["dst"])
        for script in ep["scripts"]:
            script["path"] = os.path.join(directory, script["path"])
    return manifest
