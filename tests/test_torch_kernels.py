"""The port's kernel modules vs the Pallas TPU kernels.

On the CPU each kernel wrapper runs its plain PyTorch version (the tensors
lie on the CPU); that is held against the JAX package's Pallas kernels in
interpret mode, exactly as tests/test_pallas_*.py run them.  Tolerances:

* rescore ``rtol 1e-6``: float32 sums in two orders (the port sums the
  float32 terms in float64);
* coarse post ``block_min atol 2e-6``: the port's float64 prefix vs the
  TPU kernel's two-float prefix; block arguments and tie seeds are
  integers derived from the minima and equal on random data.

Tests marked ``cuda`` compare the CUDA kernels with their plain versions
on the card (``python -m pytest tests/test_torch_kernels.py -m cuda``);
without a card they skip.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chip_smoke import KERNEL_SHAPES as _LAUNCHED  # noqa: E402
from sushi_tpu.ops import pallas_coarse, pallas_ssd  # noqa: E402
from sushi_tpu_torch.ops import coarse, rescore, sqdiff  # noqa: E402

# (batch, n, pat_cap) of each launch shape (a mesh member's slice also
# names its chunk's rows, which size its rescore grid)
KERNEL_SHAPES = tuple(shape[:3] for shape in _LAUNCHED)


def _rescore_inputs(rng, n, lp, batch=4, k=8):
    patterns = np.zeros((batch, n), np.float32)
    windows = np.zeros((batch, n), np.float32)
    pat_lens = np.full(batch, lp, np.int32)
    lags = np.zeros((batch, k), np.int32)
    for b in range(batch):
        win_len = n - 256
        windows[b, :win_len] = rng.rand(win_len)
        patterns[b, :lp] = rng.rand(lp)
        # include the last valid lag (its span ends at the window's end)
        lags[b] = np.concatenate([rng.randint(0, win_len - lp, k - 1), [win_len - lp]])
    return patterns, pat_lens, windows, lags


@pytest.mark.parametrize("n,lp,pat_cap", [(4096, 500, None), (8192, 500, 512), (16384, 3000, 3072)])
def test_rescore_matches_pallas(n, lp, pat_cap):
    arrays = _rescore_inputs(np.random.RandomState(8 + n), n, lp)
    want_num, want_energy = pallas_ssd.rescore_candidates_pallas(
        *(jnp.asarray(a) for a in arrays), pat_cap, interpret=True
    )
    before = rescore.rescore_candidates.launches
    num, energy = rescore.rescore_candidates(*(torch.from_numpy(a) for a in arrays), pat_cap)
    assert rescore.rescore_candidates.launches == before  # CPU: the plain version
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), rtol=1e-6)
    np.testing.assert_allclose(energy.numpy(), np.asarray(want_energy), rtol=1e-6)


def test_rescore_lag_near_row_end_reads_zeros():
    """A candidate whose span runs past n reads zeros (the TPU kernel's
    zero-extended window), checked against a float64 direct sum."""
    n, lp = 1024, 300
    rng = np.random.RandomState(2)
    patterns = np.zeros((1, n), np.float32)
    windows = rng.rand(1, n).astype(np.float32)
    patterns[0, :lp] = rng.rand(lp)
    lags = np.array([[n - 100, 0]], np.int32)
    num, energy = rescore.rescore_candidates(
        *(torch.from_numpy(a) for a in (patterns, np.array([lp], np.int32), windows, lags))
    )
    seg = np.zeros(lp)
    seg[:100] = windows[0, n - 100 :]
    want = np.sum((patterns[0, :lp].astype(np.float64) - seg) ** 2)
    assert float(num[0, 0]) == pytest.approx(want, rel=1e-6)
    assert float(energy[0, 0]) == pytest.approx(np.sum(seg**2), rel=1e-6)


def _coarse_inputs(rng, batch, n, full_rows=False):
    pats = np.zeros((batch, n), np.float32)
    wins = np.zeros((batch, n), np.float32)
    pat_lens = np.zeros(batch, np.int32)
    win_lens = np.zeros(batch, np.int32)
    for b in range(batch):
        wl = n if full_rows else rng.randint(n // 2, n + 1)
        pl = rng.randint(100, max(wl // 3, 101))
        wins[b, :wl] = rng.rand(wl)
        pats[b, :pl] = rng.rand(pl)
        pat_lens[b], win_lens[b] = pl, wl
    corr = np.fft.irfft(np.fft.rfft(wins, n) * np.conj(np.fft.rfft(pats, n)), n).astype(np.float32)
    pat_energy = np.sum(pats * pats, axis=1, dtype=np.float32)
    return corr, wins, pat_lens, (win_lens - pat_lens + 1).astype(np.int32), pat_energy


def _assert_coarse_matches(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-6)
    for got_part, want_part in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(got_part.numpy(), np.asarray(want_part))


@pytest.mark.parametrize(
    "n,tile_rows,full_rows",
    [(2048, 0, False), (6144, 0, False), (2048, 4, False), (6144, 8, False), (2048, 4, True)],
)
def test_coarse_post_matches_pallas(n, tile_rows, full_rows):
    """Against the resident kernel (K2) and, with ``tile_rows`` forced
    small, the tiled kernel (K3); full-length rows read the edge clamp
    P(n) at every tail lag."""
    arrays = _coarse_inputs(np.random.RandomState(17 + n + tile_rows), 3, n, full_rows)
    pat_cap = n if full_rows else n // 2
    want = pallas_coarse.coarse_post_pallas(
        *(jnp.asarray(a) for a in arrays), pat_cap, interpret=True, tile_rows=tile_rows
    )
    before = coarse.coarse_post.launches
    got = coarse.coarse_post(*(torch.from_numpy(a) for a in arrays))
    assert coarse.coarse_post.launches == before  # CPU: the plain version
    _assert_coarse_matches(got, want)


def _zero_run_inputs(n, lo, batch=2, seed=5):
    """uint8-valued rows (as the streams hold them) whose windows carry a
    run of exact zeros from sample ``lo``, several pattern lengths and
    prefix tiles long, inside the valid lag range; returns the coarse
    operands and the blocks wholly inside the run."""
    rng = np.random.RandomState(seed)
    wl, pl = n - n // 32, n // 12
    hi = lo + 4 * pl
    wins = np.zeros((batch, n), np.float32)
    pats = np.zeros((batch, n), np.float32)
    wins[:, :wl] = rng.randint(0, 256, (batch, wl)).astype(np.float32) * np.float32(1 / 255)
    wins[:, lo:hi] = 0.0
    pats[:, :pl] = rng.randint(0, 256, (batch, pl)).astype(np.float32) * np.float32(1 / 255)
    corr = np.fft.irfft(np.fft.rfft(wins, n) * np.conj(np.fft.rfft(pats, n)), n).astype(np.float32)
    arrays = (
        corr, wins, np.full(batch, pl, np.int32), np.full(batch, wl - pl + 1, np.int32),
        np.sum(pats * pats, axis=1, dtype=np.float32),
    )
    return arrays, slice(-(-lo // 128), (hi - pl + 1) // 128)


@pytest.mark.parametrize("tile_rows", [0, 4])
def test_coarse_post_zero_run_matches_pallas(tile_rows):
    """A span of exact zeros has den == 0 and scores 2.0, as in both TPU
    kernels; the energy is decided by a count of nonzero samples, not by a
    prefix difference that rounds to a tiny positive value.  The run starts
    on one of the TPU prefix's 64-sample blocks, where its two-float
    prefix is constant along zeros (from inside a block, its first lag in
    the run scores above 2.0); the port gives 2.0 from any start."""
    arrays, silent = _zero_run_inputs(16384, lo=42 * 64)
    want = pallas_coarse.coarse_post_pallas(
        *(jnp.asarray(a) for a in arrays), 16384 // 2, interpret=True, tile_rows=tile_rows
    )
    got = coarse.coarse_post(*(torch.from_numpy(a) for a in arrays))
    _assert_coarse_matches(got, want)
    assert (got[0][:, silent] == 2.0).all()


def test_coarse_post_masked_blocks_are_two():
    """Blocks wholly past the valid lag range report 2.0, and the mask
    cuts at exactly win_len - pat_len + 1."""
    rng = np.random.RandomState(11)
    n, wl, pl = 1024, 600, 200
    wins = np.zeros((1, n), np.float32)
    pats = np.zeros((1, n), np.float32)
    wins[0, :wl] = rng.rand(wl)
    pats[0, :pl] = rng.rand(pl)
    corr = np.fft.irfft(np.fft.rfft(wins, n) * np.conj(np.fft.rfft(pats, n)), n).astype(np.float32)
    block_min, _, _, _ = coarse.coarse_post(
        *(torch.from_numpy(a) for a in (
            corr, wins, np.array([pl], np.int32), np.array([wl - pl + 1], np.int32),
            np.sum(pats * pats, axis=1),
        ))
    )
    first_masked = -(-(wl - pl + 1) // 128)
    assert (block_min[0, first_masked:] == 2.0).all()
    assert (block_min[0, :first_masked] < 2.0).all()


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty(2, 1024, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rescore.rescore_candidates(meta, lens, meta, torch.empty(2, 4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        coarse.coarse_post(meta, meta, lens, lens, torch.empty(2, device="meta"))


# (n, pat_len) edge cases of the coarse kernel's tile geometry: L = 0,
# L > 4096 and not a multiple of 128, L >= n, L = n - 1, and a ragged last
# tile (n = 6144)
COARSE_EDGES = [(98304, 0), (98304, 8492), (98304, 98304), (98304, 98303), (24576, 24575),
                (6144, 5000), (6144, 0), (3 << 17, 3 << 16)]


def _check_score_block_tiles(n, pat_len):
    """Every lag u of every score block reads P(u) from the block's own tile
    and P(min(u + L, n)) from a loaded far tile (or the row total at n);
    the block loads no far tile that no lag needs."""
    ends = np.minimum(np.arange(n, dtype=np.int64) + min(max(pat_len, 0), n), n)
    for lag_tile in range(coarse.lag_tiles(n)):
        near, far = coarse.score_block_tiles(n, pat_len, lag_tile)
        lags = np.arange(lag_tile * coarse.TILE, min((lag_tile + 1) * coarse.TILE, n))
        assert near == lag_tile and np.all(lags // coarse.TILE == near)
        inside = ends[lags][ends[lags] < n]
        assert sorted(far) == sorted(set((inside // coarse.TILE).tolist())), (n, pat_len, lag_tile)
        assert all(tile * coarse.TILE < n for tile in far)


@pytest.mark.parametrize("batch,n,pat_cap", KERNEL_SHAPES)
def test_score_block_tiles_cover_every_span(batch, n, pat_cap):
    assert coarse.lag_tiles(n) == -(-n // 4096)
    for pat_len in (pat_cap, pat_cap // 2 + 77):
        _check_score_block_tiles(n, pat_len)


@pytest.mark.parametrize("n,pat_len", COARSE_EDGES)
def test_score_block_tiles_edge_cases(n, pat_len):
    _check_score_block_tiles(n, pat_len)


@pytest.mark.parametrize("batch,n,pat_cap", KERNEL_SHAPES + ((1, 4096, 0), (128, 4096, 4096)))
def test_rescore_chunks_cover_the_pattern_once(batch, n, pat_cap):
    """C and S: C a multiple of 1024 up to 4096; two waves of 132 SMs
    unless the pattern is too short for 1024-term chunks; and for every
    pat_len (one past the cap included) the blocks' chunks cover
    [0, pat_len) once."""
    chunk, chunks = rescore.rescore_geometry(batch, pat_cap)
    assert chunk % 1024 == 0 and 1024 <= chunk <= rescore.MAX_CHUNK == 4096
    assert chunks == max(-(-pat_cap // chunk), 1)
    assert batch * chunks >= 2 * 132 or chunk == 1024
    for pat_len in {0, 1, pat_cap - 1, pat_cap, pat_cap + 3 * chunk + 5} - {-1}:
        covered = np.zeros(pat_len, np.int32)
        for ranges in rescore.rescore_chunks(pat_len, chunk, chunks):
            for start, end in ranges:
                assert 0 <= start < end <= pat_len and end - start <= chunk
                covered[start:end] += 1
        assert np.all(covered == 1), (pat_len, chunk, chunks)


def test_rescore_geometry_fills_the_card_on_a_lone_row():
    """The lone 180 s pattern (1x6291456, pat_cap 3145728) gets hundreds
    of blocks, and 128x393216/49152 several per row."""
    chunk, chunks = rescore.rescore_geometry(1, 3 << 20)
    assert chunks >= 264 and chunk * chunks >= 3 << 20
    assert rescore.rescore_geometry(128, 49152)[1] >= 3


def _edge_inputs(n, pat_len, batch=4, seed=3):
    """uint8-valued rows whose windows hold zero runs crossing prefix tile
    boundaries (one row is all zero past a short prefix), every row with
    pattern length ``pat_len``."""
    rng = np.random.RandomState(seed + n + pat_len)
    wins = rng.randint(0, 256, (batch, n)).astype(np.float32) * np.float32(1 / 255)
    pats = np.zeros((batch, n), np.float32)
    pats[:, :pat_len] = rng.randint(0, 256, (batch, pat_len)).astype(np.float32) * np.float32(1 / 255)
    for b in range(batch):
        lo = max(4096 * (b + 1) - 1000 - 61 * b, 0)
        wins[b, lo : lo + 2 * 4096 + 200 * b] = 0.0
    wins[-1, 300:] = 0.0
    corr = np.fft.irfft(np.fft.rfft(wins, n) * np.conj(np.fft.rfft(pats, n)), n).astype(np.float32)
    lens = np.full(batch, pat_len, np.int32)
    return (corr, wins, lens, (n - lens + 1).astype(np.int32),
            np.sum(pats * pats, axis=1, dtype=np.float32)), pats


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_rescore_kernel_matches_plain(cuda_device):
    arrays = [
        torch.from_numpy(a).to(cuda_device)
        for a in _rescore_inputs(np.random.RandomState(1), 98304, 20000, batch=8, k=18)
    ]
    before = rescore.rescore_candidates.launches
    num, energy = rescore.rescore_candidates(*arrays, 24576)
    torch.cuda.synchronize()
    assert rescore.rescore_candidates.launches == before + 1
    want_num, want_energy = rescore.rescore_candidates_plain(*arrays, 24576)
    torch.testing.assert_close(num, want_num, rtol=1e-6, atol=0)
    torch.testing.assert_close(energy, want_energy, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6144, 98304, 393216])
def test_cuda_coarse_kernel_matches_plain(cuda_device, n):
    arrays = [
        torch.from_numpy(a).to(cuda_device)
        for a in _coarse_inputs(np.random.RandomState(n), 4, n)
    ]
    before = coarse.coarse_post.launches
    got = coarse.coarse_post(*arrays)
    torch.cuda.synchronize()
    assert coarse.coarse_post.launches == before + 1
    want = coarse.coarse_post_plain(*arrays)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    for got_part, want_part in zip(got[1:], want[1:]):
        assert torch.equal(got_part, want_part)
    assert sqdiff.select_candidates(*got, 16).shape == (4, 18)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [98304, 393216])
def test_cuda_coarse_kernel_zero_run_matches_plain(cuda_device, n):
    """The kernel's parallel float64 prefix rounds along a run of zeros; the
    nonzero count must still give the run's blocks exactly 2.0."""
    numpy_arrays, silent = _zero_run_inputs(n, lo=n // 6 + 37)
    arrays = [torch.from_numpy(a).to(cuda_device) for a in numpy_arrays]
    got = coarse.coarse_post(*arrays)
    want = coarse.coarse_post_plain(*arrays)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    for got_part, want_part in zip(got[1:], want[1:]):
        assert torch.equal(got_part, want_part)
    assert bool((got[0][:, silent] == 2.0).all())


def test_launch_count_is_thread_safe():
    """Kernel wrappers launch from several threads (the season's ingest
    threads seed while the main thread runs rounds): no count is lost."""
    import sys
    import threading

    from sushi_tpu_torch.ops import build

    def wrapper():
        pass

    wrapper.launches = 0

    def launch_many():
        for _ in range(20000):
            build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch_many) for _ in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert wrapper.launches == 8 * 20000


@pytest.mark.cuda
@pytest.mark.parametrize("n,pat_len", COARSE_EDGES)
def test_cuda_kernels_edge_cases_match_plain(cuda_device, n, pat_len):
    """Both kernels against their plain versions at the tile geometry's
    edge cases, on rows with zero runs across tile boundaries; the last
    case is a reduced lone row (1x(3<<17), pat_len 3<<16)."""
    batch = 1 if n == 3 << 17 else 4
    arrays, pats = _edge_inputs(n, pat_len, batch=batch)
    arrays = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    got = coarse.coarse_post(*arrays)
    want = coarse.coarse_post_plain(*arrays)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    for got_part, want_part in zip(got[1:], want[1:]):
        assert torch.equal(got_part, want_part)
    candidates = sqdiff.select_candidates(*got, 16)
    patterns = torch.from_numpy(pats).to(cuda_device)
    num, energy = rescore.rescore_candidates(patterns, arrays[2], arrays[1], candidates, max(pat_len, 1))
    want_num, want_energy = rescore.rescore_candidates_plain(patterns, arrays[2], arrays[1], candidates, max(pat_len, 1))
    torch.testing.assert_close(num, want_num, rtol=1e-6, atol=0)
    torch.testing.assert_close(energy, want_energy, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_rescore_pattern_longer_than_its_cap(cuda_device):
    """A pat_len above the pat_cap that sized the grid is still summed
    whole (the blocks walk it in strides)."""
    arrays = [
        torch.from_numpy(a).to(cuda_device)
        for a in _rescore_inputs(np.random.RandomState(4), 98304, 30000, batch=2, k=18)
    ]
    num, energy = rescore.rescore_candidates(*arrays, 4096)
    want_num, want_energy = rescore.rescore_candidates_plain(*arrays)
    torch.testing.assert_close(num, want_num, rtol=1e-6, atol=0)
    torch.testing.assert_close(energy, want_energy, rtol=1e-6, atol=0)


def _pooled_lags(rng, batch, n, k_count):
    """[B, K] int32 candidate lags as the pooled search gives them: runs of
    consecutive lags (neighbourhoods), clipped to [0, n - 1]."""
    width = max(k_count // 10, 1)
    bases = rng.randint(-width, n, (batch, -(-k_count // width)))
    lags = bases[:, :, None] + np.arange(width)[None, None, :]
    return np.clip(lags.reshape(batch, -1)[:, :k_count], 0, n - 1).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k_count", [18, 360, 2880, 5760])
def test_cuda_rescore_kernel_any_candidate_count(cuda_device, k_count):
    """Candidate counts past one slab of shared memory (the pooled search's
    90 * P), the last slab ragged, against the plain version."""
    rng = np.random.RandomState(k_count)
    patterns, pat_lens, windows, _ = _rescore_inputs(rng, 65536, 20000, batch=3, k=1)
    lags = _pooled_lags(rng, 3, 65536, k_count)
    arrays = [torch.from_numpy(a).to(cuda_device) for a in (patterns, pat_lens, windows, lags)]
    before = rescore.rescore_candidates.launches
    num, energy = rescore.rescore_candidates(*arrays, 24576)
    torch.cuda.synchronize()
    assert rescore.rescore_candidates.launches == before + 1 and num.shape == (3, k_count)
    want_num, want_energy = rescore.rescore_candidates_plain(*arrays, 24576)
    torch.testing.assert_close(num, want_num, rtol=1e-6, atol=0)
    torch.testing.assert_close(energy, want_energy, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 512, 1024, 12288])
def test_cuda_coarse_kernel_at_pooled_widths(cuda_device, n):
    """The pooled search's coarse rows: n / P, down to one 128-lag block."""
    rng = np.random.RandomState(n)
    batch = 8
    pats = np.zeros((batch, n), np.float32)
    wins = np.zeros((batch, n), np.float32)
    pat_lens = rng.randint(1, n // 2 + 1, batch).astype(np.int32)
    win_lens = rng.randint(n // 2, n + 1, batch).astype(np.int32)
    for b in range(batch):
        wins[b, : win_lens[b]] = rng.randint(0, 256, win_lens[b]) / np.float32(255)
        pats[b, : pat_lens[b]] = rng.randint(0, 256, pat_lens[b]) / np.float32(255)
    corr = np.fft.irfft(np.fft.rfft(wins, n) * np.conj(np.fft.rfft(pats, n)), n).astype(np.float32)
    arrays = [torch.from_numpy(a).to(cuda_device) for a in (
        corr, wins, pat_lens, (win_lens - pat_lens + 1).astype(np.int32),
        np.sum(pats * pats, axis=1, dtype=np.float32),
    )]
    got = coarse.coarse_post(*arrays)
    want = coarse.coarse_post_plain(*arrays)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    for got_part, want_part in zip(got[1:], want[1:]):
        assert torch.equal(got_part, want_part)
