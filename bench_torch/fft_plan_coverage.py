#!/usr/bin/env python3
"""How much of K10 / K11's four-step domain runs on register lines: counts,
over every fft_size from FOUR_STEP_MIN to 2^20 that ``fft_plan`` takes, the
sizes whose plan keeps a line on the generic run-time passes, and of those
the sizes whose odd part has no prime factor above 13 (so two register
lines could hold it in principle). Host only, no card:

    PYTHONPATH=. python bench_torch/fft_plan_coverage.py

Each size is planned at the smallest n2 it takes (n2 % 128 == 0, n1 % 8 ==
0). The second line counts the same with the split of an odd part across
two register lines (``_odd_pair``) turned off.
"""

from __future__ import annotations

import contextlib
from unittest import mock

from srcdsp_tpu_torch.kernels import fft_pallas as kfft


def largest_prime(q: int) -> int:
    best, d = 1, 3
    while d * d <= q:
        while q % d == 0:
            best, q = d, q // d
        d += 2
    return max(best, q)


def count() -> tuple[int, int, int]:
    sizes = generic = small = 0
    for n in range(kfft.FOUR_STEP_MIN, kfft.MAX_FFT_SIZE + 1, 1024):
        n2 = next((m for m in range(128, n + 1, 128) if n % m == 0 and (n // m) % 8 == 0), None)
        if n2 is None:
            continue
        sizes += 1
        if any(isinstance(g, kfft.LineGeometry) for g in kfft.fft_plan(n, n2).lines):
            generic += 1
            small += largest_prime(kfft._odd_split(n)[0]) <= 13
    return sizes, generic, small


def main() -> None:
    for label, ctx in (("as planned", contextlib.nullcontext()),
                       ("without _odd_pair", mock.patch.object(kfft, "_odd_pair",
                                                               lambda q, a: None))):
        with ctx:
            sizes, generic, small = count()
        print(f"{label}: {sizes} four-step sizes, {generic} with a generic line, {small} of "
              f"those with no prime above 13")


if __name__ == "__main__":
    main()
