"""Command-line interface of the PyTorch port.

The same flags as ``sushi_tpu.cli`` (full parity with the reference CLI,
Sushi's sushi.py:739-835), colored logging and the same exit-code
contract (2 on SushiError); the sync runs on CUDA.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.version import VERSION
from sushi_tpu_torch.pipeline import run

_log = logging.getLogger("sushi_tpu")


class ColoredLogFormatter(logging.Formatter):
    BOLD = "\033[1m"
    RESET = "\033[0m"
    GREY = "\033[30m\033[1m"

    error_format = BOLD + "ERROR: %(message)s" + RESET
    warn_format = BOLD + "WARNING: %(message)s" + RESET
    debug_format = GREY + "%(message)s" + RESET
    default_format = "%(message)s"

    def format(self, record):
        if record.levelno == logging.DEBUG:
            self._style._fmt = self.debug_format
        elif record.levelno == logging.WARNING:
            self._style._fmt = self.warn_format
        elif record.levelno >= logging.ERROR:
            self._style._fmt = self.error_format
        else:
            self._style._fmt = self.default_format
        return super().format(record)


def create_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sushi-tpu-torch",
        description="sushi-tpu-torch - Automatic Subtitle Shifter (PyTorch + CUDA)",
    )

    parser.add_argument("--window", default=10, type=int, metavar="<size>", dest="window",
                        help="Search window size. [%(default)s]")
    parser.add_argument("--max-window", default=30, type=int, metavar="<size>", dest="max_window",
                        help="Maximum search size allowed when trying to recover from errors. [%(default)s]")
    parser.add_argument("--rewind-thresh", default=5, type=int, metavar="<events>", dest="rewind_thresh",
                        help="Number of consecutive errors to consider results broken "
                             "and retry with a larger window. Set to 0 to disable. [%(default)s]")
    parser.add_argument("--no-grouping", action="store_false", dest="grouping",
                        help="Don't group events before shifting. Also disables error recovery.")
    parser.add_argument("--max-kf-distance", default=2, type=float, metavar="<frames>", dest="max_kf_distance",
                        help="Maximum keyframe snapping distance. [%(default)s]")
    parser.add_argument("--kf-mode", default="all", choices=["shift", "snap", "all"], dest="kf_mode",
                        help="Keyframes-based shift correction/snapping mode. [%(default)s]")
    parser.add_argument("--smooth-radius", default=3, type=int, metavar="<events>", dest="smooth_radius",
                        help="Radius of smoothing median filter. [%(default)s]")

    # 10 frames at 23.976
    parser.add_argument("--max-ts-duration", default=1001.0 / 24000.0 * 10, type=float,
                        metavar="<seconds>", dest="max_ts_duration",
                        help="Maximum duration of a line to be considered typesetting. [%(default).3f]")
    parser.add_argument("--max-ts-distance", default=1001.0 / 24000.0 * 10, type=float,
                        metavar="<seconds>", dest="max_ts_distance",
                        help="Maximum distance between two adjacent typesetting lines to be merged. [%(default).3f]")

    # test/deprecated options
    parser.add_argument("--test-shift-plot", default=None, dest="plot_path", help=argparse.SUPPRESS)
    parser.add_argument("--sample-type", default="uint8", choices=["float32", "uint8"],
                        dest="sample_type", help=argparse.SUPPRESS)

    parser.add_argument("--sample-rate", default=12000, type=int, metavar="<rate>", dest="sample_rate",
                        help="Downsampled audio sample rate. [%(default)s]")

    parser.add_argument("--src-audio", default=None, type=int, metavar="<id>", dest="src_audio_idx",
                        help="Audio stream index of the source video")
    parser.add_argument("--src-script", default=None, type=int, metavar="<id>", dest="src_script_idx",
                        help="Script stream index of the source video")
    parser.add_argument("--dst-audio", default=None, type=int, metavar="<id>", dest="dst_audio_idx",
                        help="Audio stream index of the destination video")

    parser.add_argument("--no-cleanup", action="store_false", dest="cleanup",
                        help="Don't delete demuxed streams")
    parser.add_argument("--temp-dir", default=None, dest="temp_dir", metavar="<string>",
                        help="Specify temporary folder to use when demuxing stream.")
    parser.add_argument("--chapters", default=None, dest="chapters_file", metavar="<filename>",
                        help="XML or OGM chapters to use instead of any found in the source. 'none' to disable.")
    parser.add_argument("--script", default=None, dest="script_file", metavar="<filename>",
                        help="Subtitle file path to use instead of any found in the source")

    parser.add_argument("--dst-keyframes", default=None, dest="dst_keyframes", metavar="<filename>",
                        help="Destination keyframes file")
    parser.add_argument("--src-keyframes", default=None, dest="src_keyframes", metavar="<filename>",
                        help="Source keyframes file")
    parser.add_argument("--dst-fps", default=None, type=float, dest="dst_fps", metavar="<fps>",
                        help="Fps of the destination video. Must be provided if keyframes are used.")
    parser.add_argument("--src-fps", default=None, type=float, dest="src_fps", metavar="<fps>",
                        help="Fps of the source video. Must be provided if keyframes are used.")
    parser.add_argument("--dst-timecodes", default=None, dest="dst_timecodes", metavar="<filename>",
                        help="Timecodes file to use instead of making one from the destination (when possible)")
    parser.add_argument("--src-timecodes", default=None, dest="src_timecodes", metavar="<filename>",
                        help="Timecodes file to use instead of making one from the source (when possible)")

    parser.add_argument("--src", required=True, dest="source", metavar="<filename>",
                        help="Source audio/video")
    parser.add_argument("--dst", required=True, dest="destination", metavar="<filename>",
                        help="Destination audio/video")
    parser.add_argument("-o", "--output", default=None, dest="output_script", metavar="<filename>",
                        help="Output script")

    parser.add_argument("-v", "--verbose", default=False, dest="verbose", action="store_true",
                        help="Enable verbose logging")
    parser.add_argument("--version", action="version", version=VERSION)

    return parser


def parse_args_and_run(cmd_keys, device=None) -> None:
    """Parse the flags and sync one episode on ``device`` (CUDA when None)."""
    def format_arg(arg):
        return arg if " " not in arg else '"{0}"'.format(arg)

    args = create_arg_parser().parse_args(cmd_keys)

    handler = logging.StreamHandler()
    try:
        use_colors = os.isatty(sys.stderr.fileno())
    except (OSError, ValueError):
        use_colors = False
    handler.setFormatter(ColoredLogFormatter() if use_colors else logging.Formatter("%(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(logging.DEBUG if args.verbose else logging.INFO)

    _log.info("sushi-tpu-torch is running with arguments: %s", " ".join(map(format_arg, cmd_keys)))
    start = time.time()
    run(args, device=device)
    _log.info("Done in %fs", time.time() - start)


def main() -> None:
    try:
        parse_args_and_run(sys.argv[1:])
    except SushiError as error:
        logging.critical("%s", error)
        sys.exit(2)


if __name__ == "__main__":
    main()
