"""The yardstick's operation and byte counts against sums written out by
hand from the published shapes (ffhq 1024²: synthesis channels 512, 512,
512, 512, 256, 128, 64, 32, 16 at 4² ... 1024²; decoder features 32 x 8,
16 -> 2)."""

import json
import os

import pytest

from gsbench import counts, harness

CFG = {n: json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                      n + ".json")))
       for n in ("stylegan-ffhq-1024", "segdecoder-ffhq-1024")}
GEN, FIT = CFG["stylegan-ffhq-1024"], CFG["segdecoder-ffhq-1024"]
C = [512, 512, 512, 512, 256, 128, 64, 32, 16]
S = [4, 8, 16, 32, 64, 128, 256, 512, 1024]


def test_generator_flop_by_hand():
    mapping = 8 * 2 * 512 * 512
    affine = sum(2 * 2 * 512 * 2 * c for c in C)
    conv_2 = sum(2 * 9 * c * c * s * s for c, s in zip(C, S))
    up = (2 * 9 * 512 * 512 * 8 * 8 + 2 * 9 * 512 * 512 * 16 * 16
          + 2 * 9 * 512 * 512 * 32 * 32 + 2 * 9 * 512 * 256 * 64 * 64
          + 2 * 16 * 256 * 128 * 64 * 64 + 2 * 16 * 128 * 64 * 128 * 128
          + 2 * 16 * 64 * 32 * 256 * 256 + 2 * 16 * 32 * 16 * 512 * 512)
    blur = sum(2 * 9 * c * s * s for c, s in zip(C[1:], S[1:]))
    to_rgb = 2 * 16 * 3 * 1024 * 1024
    assert counts.generator_flop(GEN["gan"]) == \
        mapping + affine + conv_2 + up + blur + to_rgb


def decoder_convs_by_hand():
    """(cin, cout, k, res, needs_dx) of every decoder conv."""
    out = [(cin, 32 if i < 8 else 16, 3, 4 * 2 ** i, False)
           for i, cin in enumerate(C)]
    out += [(32, 32, 3, 8, True), (32, 32, 3, 8, True)]          # main_0
    for i in range(1, 7):                                         # main_1-6
        r = 8 * 2 ** i
        out += [(64, 32, 3, r, True), (32, 32, 3, r, True),
                (64, 32, 1, r, True)]
    out += [(64, 16, 3, 1024, True), (16, 16, 3, 1024, True),    # main_7
            (64, 16, 1, 1024, True)]
    out += [(32, 2, 3, 1024, True)]                               # main_8
    return out


def test_decoder_flop_by_hand():
    fwd = sum(2 * k * k * ci * co * r * r
              for ci, co, k, r, _ in decoder_convs_by_hand())
    dx = sum(2 * k * k * ci * co * r * r
             for ci, co, k, r, d in decoder_convs_by_hand() if d)
    assert counts.decoder_flop(GEN["decoder"], 4) == fwd
    assert counts.decoder_flop(FIT["decoder"], 4, train=True) == \
        2 * fwd + dx
    assert counts.generate_flop_per_sample(GEN) == \
        counts.generator_flop(GEN["gan"]) + fwd
    assert counts.train_flop_per_sample(FIT) == 2 * fwd + dx


def test_kernel1_bound_by_hand():
    total = 0.0
    for c, s in zip(C, S):
        n = 8
        nbytes = 2 * (n * s * s * 2 * c + 9 * c * c) + 4 * (
            n * s * s + 2 * c + 2 * n * c)
        flop = 18 * n * s * s * c * c
        total += max(nbytes / 3.35e12, flop / 989e12) * 1e3
    assert counts.kernel1_bound_ms(GEN["gan"], 8, "bf16") == \
        pytest.approx(total, rel=1e-12)
    # the figure PERF.md gives for the same sum
    assert total == pytest.approx(0.425, abs=5e-4)


def test_kernel2_bound_by_hand():
    total = 0.0
    calls = 0
    for ci, co, k, r, _ in decoder_convs_by_hand():
        if k != 3:
            continue
        calls += 1
        n = 8
        nbytes = 2 * (n * r * r * (ci + co) + 9 * ci * co) + 4 * co
        total += max(nbytes / 3.35e12, 18 * n * r * r * ci * co / 989e12) \
            * 1e3
    assert calls == 26
    assert counts.kernel2_bound_ms(GEN["decoder"], 4, 8, "bf16") == \
        pytest.approx(total, rel=1e-12)
    assert total == pytest.approx(1.291, abs=5e-4)


def test_kernel3_calls_and_bound_by_hand():
    calls = []
    for ci, co, k, r, dx in decoder_convs_by_hand():
        if k == 3 and ci <= 128 and co <= 128:
            calls.append((r, ci, co, True))
            if dx:
                calls.append((r, co, ci, False))
    assert len(calls) == 38 and sum(1 for c in calls if c[3]) == 21
    total = 0.0
    for r, ci, co, bias in calls:
        nbytes = 4 * (r * r * (ci + co) + 9 * ci * co) + (4 * co if bias
                                                          else 0)
        total += max(nbytes / 3.35e12, 3 * 18 * r * r * ci * co / 495e12) \
            * 1e3
    assert len(counts.kernel3_calls(FIT["decoder"], 4, 1)) == 38
    assert counts.kernel3_bound_ms(FIT["decoder"], 4, 1) == \
        pytest.approx(total, rel=1e-12)
    assert total == pytest.approx(0.725, abs=5e-4)


def test_peaks():
    assert counts.effective_peak("bf16") == 989e12
    assert counts.effective_peak("f32") == 495e12 / 3
    with pytest.raises(ValueError):
        counts.effective_peak("int4")
