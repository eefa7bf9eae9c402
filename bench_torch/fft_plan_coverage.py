#!/usr/bin/env python3
"""Which lines K10 / K11's four-step domain runs on: counts, over every
fft_size from FOUR_STEP_MIN to 2^20 that ``fft_plan`` takes, the sizes whose
plan holds a Bluestein line, those Bluestein lines by transform length M, and
the lines of any other kind (none: every line is a register line or a
Bluestein line). Host only, no card:

    PYTHONPATH=. python bench_torch/fft_plan_coverage.py

Each size is planned at the smallest n2 it takes (n2 % 128 == 0, n1 % 8 ==
0). The second line counts the same with the split of an odd part across
two register lines (``_odd_pair``) turned off.
"""

from __future__ import annotations

import collections
import contextlib
from unittest import mock

from srcdsp_tpu_torch.kernels import fft_pallas as kfft


def count() -> tuple[int, int, collections.Counter, int]:
    """(sizes, sizes with a Bluestein line, Bluestein lines by M, lines of
    another kind)."""
    sizes = blue = other = 0
    by_m = collections.Counter()
    for n in range(kfft.FOUR_STEP_MIN, kfft.MAX_FFT_SIZE + 1, 1024):
        n2 = next((m for m in range(128, n + 1, 128) if n % m == 0 and (n // m) % 8 == 0), None)
        if n2 is None:
            continue
        sizes += 1
        lines = kfft.fft_plan(n, n2).lines
        blue += any(isinstance(g, kfft.BluesteinLine) for g in lines)
        for g in lines:
            if isinstance(g, kfft.BluesteinLine):
                by_m[1 << g.log2m] += 1
            elif not isinstance(g, kfft.LineShape):
                other += 1
    return sizes, blue, by_m, other


def main() -> None:
    for label, ctx in (("as planned", contextlib.nullcontext()),
                       ("without _odd_pair", mock.patch.object(kfft, "_odd_pair",
                                                               lambda q, a: None))):
        with ctx:
            sizes, blue, by_m, other = count()
        ms = ", ".join(f"M {m}: {by_m[m]}" for m in sorted(by_m))
        print(f"{label}: {sizes} four-step sizes, {blue} with a Bluestein line (lines by "
              f"transform length: {ms}), {other} generic lines")


if __name__ == "__main__":
    main()
