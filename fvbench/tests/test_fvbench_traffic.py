"""The traffic generator: every seed gets the same multiset of lengths and
gaps in another order, arrivals stay inside the window, mels are
deterministic in the seed, and the serve cell warms the buckets and group
sizes that the service forms."""

import numpy as np
import pytest

from fvbench import traffic

LAW = {"law": "lognormal", "median": 390, "sigma": 0.45, "min": 100, "max": 1500}


def test_same_lengths_in_another_order():
    a, b = traffic.lengths(LAW, 3000, 2 ** 31 + 1), traffic.lengths(LAW, 3000, 2 ** 33 + 7)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() >= 100 and a.max() <= 1500
    assert np.median(a) == pytest.approx(390, abs=1)
    assert np.mean(a) == pytest.approx(390 * np.exp(0.45 ** 2 / 2), rel=0.02)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_poisson_arrivals(seed):
    due = traffic.arrivals({"process": "poisson", "rate": 90.0}, 30.0, seed)
    assert len(due) == 2700
    assert due[0] == 0.0 and due[-1] < 30.0 and np.all(np.diff(due) > 0)
    gaps = np.diff(due)
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(1.0, abs=0.1)  # exponential


def test_mels_are_the_seeds():
    a = traffic.MelPool({"mean": 0.5, "std": 0.25}, 9).many([100, 200])
    b = traffic.MelPool({"mean": 0.5, "std": 0.25}, 9).many([100, 200])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[1].shape == (200, 80) and a[1].dtype == np.float32
    assert 0.0 <= a[0].min() and a[0].max() <= 1.0


def test_bucket_rule_is_the_services():
    from fastvocoder_tpu_torch.models.batched import bucket_length

    for T in range(1, 1600, 7):
        assert traffic.bucket(T, 64) == bucket_length(T, 64)
    assert [traffic.bucket(T, 64) for T in (1, 64, 65, 1500)] == [64, 64, 128, 1536]


@pytest.mark.parametrize("pad,max_batch", [("pow2", 32), ("pow2", 24), ("exact", 6)])
def test_warmed_group_sizes_are_the_services(pad, max_batch):
    from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
    from fvbench.drivers.serve import group_sizes

    synth = BatchedSynthesizer(lambda mel: mel, 240, device="cpu", max_batch=max_batch,
                               batch_pad=pad)
    formed = {synth._group_size(n) for n in range(1, max_batch + 1)}
    assert group_sizes({"max_batch": max_batch, "batch_pad": pad}) == sorted(formed)
