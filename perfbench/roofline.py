"""The card's peaks and the bytes a kernel must move, kept with the benchmark.

``coarse_bytes`` is the coarse pass's byte count (the correlation and the
window rows read once, the pattern length, lag count and energy read once,
the 128-lag block minima and arguments and the two tie seeds written
once), linear in the rows of a launch, so the program's per-bucket count
of padded rows gives the bytes of every launch in the window.  The kernel
is bound by these bytes; its share of the roofline is the least time they
take at the card's bandwidth over the time its four launches ran.
"""

# HBM bytes per second by the card's name (NVIDIA's data sheet, SXM part at 700 W)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
# the device functions of csrc/coarse_post.cu, one launch each per call
COARSE_KERNELS = ("tile_sums_kernel", "carry_scan_kernel", "scores_kernel", "ties_kernel")
LANES = 128


def coarse_bytes(batch, n):
    return batch * (n * 8 + (n // LANES) * 8 + 5 * 4)


def kernel_seconds(ctx, names):
    """Device seconds of the traced kernels whose name holds one of ``names``."""
    trace = ctx.get("trace") or {}
    return sum(seconds for kernel, seconds in trace.get("kernel_seconds", {}).items()
               if any(name in kernel for name in names))


def coarse_post_share(ctx):
    """Percent of the coarse kernel's byte roofline, or None."""
    peak = PEAK_BYTES_PER_S.get(ctx.get("card"))
    seconds = kernel_seconds(ctx, COARSE_KERNELS)
    if not peak or seconds <= 0:
        return None
    moved = sum(coarse_bytes(padded, int(n)) for n, (_, padded, _) in ctx["telemetry"]["buckets"].items())
    return 100.0 * moved / peak / seconds


def idle_share(ctx):
    trace = ctx.get("trace") or {}
    if not trace.get("busy_s"):
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
