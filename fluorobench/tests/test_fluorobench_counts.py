"""Operations and bytes from the configurations' shapes."""

import json

import pytest

from fluorobench import counts
from fluorobench.tests.small import ROOT

CFG8 = json.loads((ROOT / "fluorobench/configs/deepfluoro-8x.json").read_text())
CFG2 = json.loads((ROOT / "fluorobench/configs/deepfluoro-2x.json").read_text())


def test_forward_flops_match_the_flop_counter_figure():
    # torch.utils.flop_counter on the port's net at 192^2 gave this (PERF.md §5)
    assert counts.unet_forward_flops(CFG8, 192) == 18_166_063_104


def test_padded_sizes_and_step():
    assert counts.pad_size(CFG8, 179) == 193 and counts.pad_size(CFG8, 180) == 192
    assert counts.pad_size(CFG2, 718) == 736
    assert counts.train_step_flops(CFG8, 179) == 3 * counts.unet_forward_flops(CFG8, 193)


@pytest.mark.parametrize("batch,frame,out,bound_us", [
    (5, 180, 192, 0.800), (5, 179, 193, 0.796), (5, 718, 736, 12.467), (2, 1436, 1440, 19.725), (30, 180, 192, 4.803),
])
def test_warp_bounds_of_perf_md(batch, frame, out, bound_us):
    assert counts.warp_pair_bound_s(batch, frame, out) * 1e6 == pytest.approx(bound_us, abs=5e-4)
