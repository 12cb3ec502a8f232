"""One script synced by the reference, end to end."""

from perfbench.reference import script as script_mod
from perfbench.reference import search


def sync(src, dst, script_text, options, device="cpu", precision="float64"):
    """(per-group results, written SRT text) of ``script_text`` synced
    from ``src`` to ``dst`` (analysis buffers, :func:`.audio.analysis_buffer`)
    with the CLI's ``options`` (window, max_window, rewind_thresh,
    smooth_radius, max_ts_duration, max_ts_distance)."""
    events = script_mod.parse_srt(script_text)
    groups = script_mod.search_groups(events, src.duration_seconds, options["max_ts_duration"],
                                      options["max_ts_distance"])
    spans = search.spans(groups, src)
    matcher = search.Matcher(src, dst, spans, precision=precision, device=device)
    results = search.run_search(spans, dst.duration_seconds, matcher.find, options["window"],
                                options["max_window"], options["rewind_thresh"], dst.sample_rate)
    script_mod.apply_results(groups, results)
    script_mod.postprocess(events, options["smooth_radius"])
    return results, script_mod.write_srt(events)
