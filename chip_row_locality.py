#!/usr/bin/env python3
"""Which per-row sums of the match path depend on the batch, on the card.

    python3 chip_row_locality.py

A mesh member matches a slice of a chunk, and each of its rows must come
out as in the whole chunk, bit for bit.  At every whole-chunk
shape of ``chip_smoke.py`` phase 2, this script matches each batch
whole and as two halves (``chip_smoke.kernel_inputs``, ``SEEDS`` inputs
per shape) and counts what differs:

* the pattern energy [B]: float32 ``torch.sum`` of the squares (the sum
  the port used before the mesh), float64 ``torch.sum``, and
  ``sqdiff.row_energy``;
* the rescore kernel's (num, energy) [B, 2K]: each half with the grid of
  its own rows, and with the whole chunk's (``chunk_rows``);
* the correlation [B, n] (``sqdiff.correlate_rows``) and the candidate
  lags [B, K+2] rows;
* the match's (score, lag) rows, with each of those two choices alone
  and with both (the first differing rows of the last are printed).

It also times ``row_energy`` against the float32 ``torch.sum`` (CUDA
events around 10 calls, host work included), and lists at each FFT size
the batch sizes for which one cuFFT call gives each row what a batch of
one gives it.  The last line of standard
output is one JSON object with every count and time and the card's name
and power limit.  Needs one CUDA device; imports no JAX.
"""

import json
import os
import sys



def shapes():
    """(batch, n, pat_cap): every whole-chunk shape of ``chip_smoke.py``
    phase 2 with two rows or more."""
    import chip_smoke

    return [entry for entry in chip_smoke.KERNEL_SHAPES if len(entry) == 3 and entry[0] > 1]


SEEDS = 4


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_row_locality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from sushi_tpu_torch.ops import build, coarse, rescore, sqdiff

    device = torch.device("cuda", 0)
    build.library()
    row_energy = sqdiff.row_energy
    energies = {
        "torch.sum float32": lambda rows, cap: torch.sum(rows * rows, dim=1),
        "torch.sum float64": lambda rows, cap: torch.sum(rows.to(torch.float64) ** 2, dim=1).to(torch.float32),
        "row_energy": row_energy,
    }
    record = {"card": chip_smoke.card_line(), "seeds": SEEDS, "shapes": {}}
    for batch, n, pat_cap in shapes():
        counts, times, examples = {}, {}, []
        for seed in range(SEEDS):
            patterns, pat_lens, windows, win_lens = chip_smoke.kernel_inputs(batch, n, pat_cap, device, seed)
            halves = (slice(0, batch // 2), slice(batch // 2, batch))

            def differ(name, fn, per_row=False):
                whole = fn(slice(0, batch), batch)
                halved = torch.cat([fn(part, batch // 2) for part in halves])
                diff = whole != halved
                counts[name] = counts.get(name, 0) + int((diff.reshape(batch, -1).any(dim=1) if per_row else diff).sum())
                if name.startswith("match rows, row_energy, halves on their chunk"):
                    for row in torch.nonzero(diff.any(dim=1))[:4, 0].tolist():
                        examples.append("seed %d row %d (%s): whole %s, halves %s" % (
                            seed, row, "plateau" if row % 2 else "noisy", whole[row].tolist(), halved[row].tolist()))

            for name, energy in energies.items():
                differ("pattern energy values, " + name, lambda part, rows: energy(patterns[part], pat_cap))
            differ("correlation values", lambda part, rows: sqdiff.correlate_rows(
                patterns[part], windows[part], n))
            corr = sqdiff.correlate_rows(patterns, windows, n)
            candidates = sqdiff.select_candidates(*coarse.coarse_post(
                corr, windows, pat_lens, win_lens - pat_lens + 1, row_energy(patterns, pat_cap)), 16)
            del corr
            differ("candidate rows", lambda part, rows: sqdiff.select_candidates(*coarse.coarse_post(
                sqdiff.correlate_rows(patterns[part], windows[part], n), windows[part], pat_lens[part],
                win_lens[part] - pat_lens[part] + 1, row_energy(patterns[part], pat_cap)), 16), per_row=True)
            for grid in ("own", "chunk's"):
                differ("rescore values, halves on their %s grid" % grid, lambda part, rows: torch.cat(
                    rescore.rescore_candidates(patterns[part], pat_lens[part], windows[part], candidates[part],
                                               pat_cap, batch if grid == "chunk's" else rows), dim=1))
            for energy_name in ("torch.sum float32", "row_energy"):
                for grid in ("own", "chunk's"):
                    sqdiff.row_energy = energies[energy_name]
                    try:
                        differ("match rows, %s, halves on their %s grid" % (energy_name, grid),
                               lambda part, rows: torch.stack([t.to(torch.float64) for t in sqdiff.match_padded_batch(
                                   patterns[part], pat_lens[part], windows[part], win_lens[part], n, 16, pat_cap,
                                   batch if grid == "chunk's" else rows)], dim=1), per_row=True)
                    finally:
                        sqdiff.row_energy = row_energy
            if seed == 0:
                times = {
                    "row_energy_ms": chip_smoke.time_ms(lambda: row_energy(patterns, pat_cap)),
                    "torch_sum_ms": chip_smoke.time_ms(lambda: torch.sum(patterns * patterns, dim=1)),
                }
            del patterns, windows
            torch.cuda.empty_cache()
        shape = "%dx%d/%d" % (batch, n, pat_cap)
        record["shapes"][shape] = dict(counts, examples=examples, **times)
        for example in examples:
            print("%-18s %s" % (shape, example), flush=True)
        for name, count in counts.items():
            print("%-18s %-60s %d" % (shape, name, count), flush=True)
        for name, ms in times.items():
            print("%-18s %-60s %.4f ms" % (shape, name, ms), flush=True)
    record["fft_batches"] = fft_batches(torch, device, sorted({n for _, n, _ in shapes()}))
    print(json.dumps(record))
    return 0


def fft_batches(torch, device, sizes, batches=(2, 3, 4, 8, 16, 32, 43, 64, 128)):
    """For each FFT size n: the batch sizes whose ``torch.fft`` rfft and
    irfft (one cuFFT call each) give every row bit for bit what a batch of
    one gives that row."""
    found = {}
    for n in sizes:
        rows = torch.rand(max(batches), n, generator=torch.Generator().manual_seed(n)).to(device)
        spectra = torch.cat([torch.fft.rfft(rows[i : i + 1], n=n) for i in range(max(batches))])
        signals = torch.cat([torch.fft.irfft(spectra[i : i + 1], n=n) for i in range(max(batches))])
        same = []
        for batch in batches:
            if batch * n > 1 << 26:
                continue
            if torch.equal(torch.fft.rfft(rows[:batch], n=n), spectra[:batch]) and torch.equal(
                    torch.fft.irfft(spectra[:batch], n=n), signals[:batch]):
                same.append(batch)
        found[n] = same
        print("fft %-8d batches equal to one row's: %s" % (n, same), flush=True)
        del rows, spectra, signals
    return found


if __name__ == "__main__":
    sys.exit(main())
