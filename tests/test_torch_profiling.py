"""The profiler's reading of device events (``tpu_resnet_torch/tools/
profiling.py``): busy times are unions of intervals, the streams that ran
a kernel of the ImageNet decode stage are the decode engine's, every event
on them (copies included) counted apart from the step's, and the rows by
name leave out names that took no device time. The events are written out
here; the profiler itself needs the card."""

import numpy as np
import pytest
import torch

from tpu_resnet_torch.tools import profiling


@pytest.mark.parametrize("intervals, ms", [
    ([], 0.0),
    ([(0.0, 10.0)], 0.01),
    ([(0.0, 10.0), (20.0, 25.0)], 0.015),
    ([(0.0, 10.0), (5.0, 12.0)], 0.012),
    ([(0.0, 10.0), (2.0, 3.0), (9.0, 9.5)], 0.01),
    ([(20.0, 25.0), (0.0, 10.0), (10.0, 20.0)], 0.025),
    ([(0.0, 10.0), (30.0, 30.0), (40.0, 35.0)], 0.01),
])
def test_union_ms(intervals, ms):
    assert profiling.union_ms(intervals) == pytest.approx(ms)


def test_split_streams_counts_the_decode_streams_apart():
    """Stream 7 runs the step (a kernel, then a copy); streams 20 and 21
    are two decode workers (tr_resize_crop, nvJPEG's IDCT and their
    copies) overlapping it. Two calls."""
    events = [("bottleneck_fwd_kernel", 7, 0.0, 10.0),
              ("Memcpy HtoD (Pageable -> Device)", 7, 10.0, 12.0),
              ("Memcpy HtoD (Pinned -> Device)", 20, 1.0, 3.0),
              ("tr_resize_crop_kernel", 20, 5.0, 8.0),
              ("nvjpeg::idct_kernel", 21, 11.0, 20.0),
              ("Memcpy HtoD (Pinned -> Device)", 21, 19.0, 22.0),
              ("Memcpy HtoD (Pageable -> Device)", 21, 22.0, 23.0)]
    got = profiling.split_streams(events, iters=2)
    assert got["device_busy_ms"] == pytest.approx(0.023 / 2)
    assert got["step_busy_ms"] == pytest.approx(0.012 / 2)
    assert got["decode_ms"] == pytest.approx((0.002 + 0.003 + 0.012) / 2)
    # A name seen on the step's stream stays the step's.
    assert got["decode_names"] == {"Memcpy HtoD (Pinned -> Device)",
                                   "tr_resize_crop_kernel",
                                   "nvjpeg::idct_kernel"}
    assert [(s["stream"], s["decode"], s["events_per_call"])
            for s in got["streams"]] == [(7, False, 1.0), (20, True, 1.0),
                                         (21, True, 1.5)]
    assert got["streams"][2]["busy_ms_per_call"] == pytest.approx(0.012 / 2)


def test_split_streams_one_stream_and_none():
    """On one stream the busy time is the events' sum and nothing is the
    decode's; with no device event the busy times are None."""
    events = [("sbr_kernel", 7, 0.0, 4.0), ("sbr_bwd_kernel", 7, 4.0, 10.0),
              ("xent_fwd_kernel", 7, 15.0, 16.0)]
    got = profiling.split_streams(events, iters=1)
    assert got["device_busy_ms"] == got["step_busy_ms"] == \
        pytest.approx(0.011)
    assert got["decode_ms"] == 0.0 and got["decode_names"] == set()
    empty = profiling.split_streams([], iters=3)
    assert empty["device_busy_ms"] is None and empty["step_busy_ms"] is None
    assert empty["streams"] == []


def test_kernel_rows_by_device_time():
    """Per call, by device time; a name that took no device time is left
    out, and a name that did counts every launch the profiler saw."""
    rows = profiling.kernel_rows([("xent_bwd_kernel", 2, 6.0),
                                  ("Memset (Device)", 1, 0.0),
                                  ("sbr_bwd_kernel" + "x" * 100, 4, 40.0)],
                                 iters=2)
    assert [(r["name"].rstrip("x"), r["ms_per_call"],
             r["launches_per_call"]) for r in rows] == [
        ("sbr_bwd_kernel", 0.02, 2.0), ("xent_bwd_kernel", 0.003, 1.0)]
    assert len(rows[0]["name"]) == 90


def test_host_batches_copies_the_images_each_step():
    images = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    labels = np.array([3, 1], np.int32)
    feed = profiling.host_batches(images, labels, torch.device("cpu"))
    (a, la), (b, lb) = next(feed), next(feed)
    assert torch.equal(a, torch.from_numpy(images)) and torch.equal(a, b)
    assert la is lb and la.tolist() == [3, 1]
