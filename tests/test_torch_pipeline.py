"""End to end through the port's CLI on the CPU, held against sushi_tpu's:
the retimed scripts must be byte-identical."""

import filecmp
import logging
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from sushi_tpu.cli import parse_args_and_run as jax_cli  # noqa: E402
from sushi_tpu_torch.cli import parse_args_and_run as torch_cli  # noqa: E402
from sushi_tpu_torch.errors import SushiError  # noqa: E402

from tests.fixtures import write_ass, write_srt  # noqa: E402
from tests.test_pipeline import EVENTS, media  # noqa: E402,F401  (module fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quiet(cli, args, **kwargs):
    root = logging.getLogger()
    had = list(root.handlers)
    try:
        cli(args, **kwargs)
    finally:
        for handler in root.handlers:
            if handler not in had:
                root.removeHandler(handler)


@pytest.mark.parametrize(
    "ext,flags",
    [("srt", []), ("ass", []), ("srt", ["--no-grouping"]), ("srt", ["--sample-type", "float32"])],
)
def test_script_byte_identical_to_jax(media, tmp_path, ext, flags):  # noqa: F811
    _, src_wav, dst_wav = media
    script = str(tmp_path / ("in." + ext))
    (write_srt if ext == "srt" else write_ass)(script, EVENTS)
    want = str(tmp_path / ("jax." + ext))
    got = str(tmp_path / ("torch." + ext))
    _quiet(jax_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script, "-o", want, *flags])
    _quiet(
        torch_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script, "-o", got, *flags],
        device="cpu",
    )
    assert filecmp.cmp(want, got, shallow=False)


def test_sync_never_imports_jax(media, tmp_path):  # noqa: F811
    """Importing the port and syncing an episode leaves JAX and every
    ``sushi_tpu`` module unimported.  A subprocess, because this test
    process imported both already."""
    _, src_wav, dst_wav = media
    script = str(tmp_path / "in.srt")
    out = str(tmp_path / "out.srt")
    write_srt(script, EVENTS)
    code = textwrap.dedent(
        """
        import sys
        import sushi_tpu_torch
        from sushi_tpu_torch.cli import parse_args_and_run
        def reference_modules():
            return sorted(m for m in sys.modules if m == "sushi_tpu" or m.startswith("sushi_tpu."))
        assert "jax" not in sys.modules, "importing the port imported jax"
        assert not reference_modules(), "importing the port imported %s" % reference_modules()
        parse_args_and_run(sys.argv[1:], device="cpu")
        assert "jax" not in sys.modules, "the sync imported jax"
        assert not reference_modules(), "the sync imported %s" % reference_modules()
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, SUSHI_STREAM_CACHE=str(tmp_path / "cache"))
    result = subprocess.run(
        [sys.executable, "-c", code, "--src", src_wav, "--dst", dst_wav, "--script", script, "-o", out],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    assert os.path.getsize(out) > 0


def test_default_device_without_cuda_raises(media, tmp_path, monkeypatch):  # noqa: F811
    """device=None means CUDA; without it the sync fails loudly instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, src_wav, dst_wav = media
    script = str(tmp_path / "in.srt")
    write_srt(script, EVENTS)
    with pytest.raises(SushiError, match="CUDA"):
        _quiet(torch_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script])


@pytest.mark.parametrize(
    "make_args,match",
    [
        (lambda src, dst, tmp: ["--src", str(tmp / "none.wav"), "--dst", dst, "--script", "s.srt"], "Source"),
        (lambda src, dst, tmp: ["--src", src, "--dst", dst], "[Ss]cript"),
        (lambda src, dst, tmp: ["--src", src, "--dst", dst, "--script", str(tmp / "in.srt"),
                                "-o", str(tmp / "o.ass")], "don't match"),
    ],
)
def test_cli_contract_errors(media, tmp_path, make_args, match):  # noqa: F811
    _, src_wav, dst_wav = media
    write_srt(str(tmp_path / "in.srt"), EVENTS)
    with pytest.raises(SushiError, match=match):
        _quiet(torch_cli, make_args(src_wav, dst_wav, tmp_path), device="cpu")


def test_main_module_help():
    result = subprocess.run(
        [sys.executable, "-m", "sushi_tpu_torch", "--help"],
        env=dict(os.environ, PYTHONPATH=REPO_ROOT), capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0
    assert "sushi-tpu-torch" in result.stdout and "--max-window" in result.stdout
