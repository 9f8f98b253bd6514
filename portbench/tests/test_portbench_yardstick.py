"""The statistics and byte counts that the metrics read: the percentile
is taken over every round, the rooflines' bytes are the streams their
kernels must move, and a metric with nothing to read is left out."""

from __future__ import annotations

import statistics

import pytest

from portbench import yardstick
from portbench.metrics import (adamw_roofline, device_idle_share, gossip_mix_roofline, mfu,
                               round_p90_s, train_tokens_per_s)


@pytest.mark.parametrize("n", [2, 5, 11, 57, 64])
def test_percentile_over_all_rounds(n):
    rounds = [0.7 + 0.013 * ((7 * i) % n) for i in range(n)]
    want = statistics.quantiles(rounds, n=10, method="inclusive")[8]
    assert yardstick.percentile(rounds, 90) == pytest.approx(want, rel=1e-12)
    assert round_p90_s.read({"round_s": rounds}) == pytest.approx(want, rel=1e-12)
    slow = rounds + [5.0]                       # one slow round moves the tail, never drops out
    assert yardstick.percentile(slow, 90) >= yardstick.percentile(rounds, 90)
    assert yardstick.percentile(rounds, 100) == max(rounds)


def test_adamw_bytes_are_seven_float32_streams():
    import torch

    from portbench.training import update_bytes

    assert update_bytes(torch.zeros(630_736_896, device="meta"), 7) == 7 * 630_736_896 * 4
    share = adamw_roofline.read({"optimizer": {"bytes": 3.35e12, "seconds": 2.0}})
    assert share == pytest.approx(50.0)
    assert adamw_roofline.read({}) is None


def test_gossip_mix_bytes_are_k_plus_one_rows():
    prof = {"kernels": {"gossip_mix_kernel<2>": 0.010, "sm80_xmma_gemm": 1.0},
            "mix_bytes": (2 + 1) * 4 * 630_736_896 * 4, "rounds": 1}
    share = gossip_mix_roofline.read({"profile": prof})
    assert share == pytest.approx(100 * 3 * 4 * 630_736_896 * 4 / 3.35e12 / 0.010)
    assert gossip_mix_roofline.read({"profile": dict(prof, kernels={"gemm": 1.0})}) is None


def test_rates_and_shares():
    rec = {"round_s": [1.0, 2.0, 1.0], "tokens": [100, 100, 100], "window_s": 4.0,
           "flops_per_token": 495e12 / 100, "profiled": [1]}
    assert train_tokens_per_s.read(rec) == 75.0
    assert mfu.read(rec) == pytest.approx(100.0)       # the profiled round left out
    assert device_idle_share.read({"profile": {"busy_s": 3.0, "window_s": 4.0}}) == 25.0
    assert device_idle_share.read({"profile": None}) is None
    assert train_tokens_per_s.read({}) is None


def test_worst_leaf_gap_and_rule():
    ref = [[1.0, 2.0, 4.0, 1e-9]]
    assert yardstick.worst_leaf_gap([[1.0, 2.0, 4.0, 1e-9]], ref) == 0
    assert yardstick.worst_leaf_gap([[1.0, 2.2, 4.0, 1e-9]], ref) == pytest.approx(0.1)
    # a leaf far under the median is measured against the median leaf
    assert yardstick.worst_leaf_gap([[1.0, 2.0, 4.0, 2e-9]], ref) == pytest.approx(1e-9 / 2)
    rule = yardstick.moving_leaves(ref)
    assert rule == [[True, True, True, False]]
    assert yardstick.loss_gap([10.0, 11.0], [10.0, 10.0]) == pytest.approx(0.1)
