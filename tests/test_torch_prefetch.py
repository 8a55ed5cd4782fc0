"""Port parity for the host -> device prefetch (data/prefetch.py): the four
cases of the JAX package's tests/test_prefetch.py (order and transform,
overlap, an exception in the iterator, an exception in ``put_fn``), each
run on the port's ``prefetch_to_device`` and on the JAX package's, plus
the abandonment of an iterator and ``DevicePut`` on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

from stroke_prediction_tpu.data import prefetch as jax_prefetch
from stroke_prediction_tpu_torch.data import prefetch

IMPLS = {"port": prefetch.prefetch_to_device,
         "jax": jax_prefetch.prefetch_to_device}


@pytest.fixture(params=sorted(IMPLS))
def prefetch_to_device(request):
    return IMPLS[request.param]


def test_order_and_transform(prefetch_to_device):
    out = list(prefetch_to_device(range(10), lambda b: b * 2, depth=2))
    assert out == [2 * i for i in range(10)]


def test_overlap(prefetch_to_device):
    """The worker stages ahead: consuming slowly still sees every item, and
    production overlaps consumption."""
    t0 = time.time()

    def slow_iter():
        for i in range(5):
            time.sleep(0.05)
            yield i

    got = []
    for x in prefetch_to_device(slow_iter(), lambda b: b, depth=2):
        time.sleep(0.05)
        got.append(x)
    # serial would be ~0.5 s; overlapped ~0.3 s
    assert got == list(range(5))
    assert time.time() - t0 < 0.45


def test_exception_propagates(prefetch_to_device):
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), lambda b: b)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_put_fn_exception(prefetch_to_device):
    it = prefetch_to_device(range(3), lambda b: 1 // b)  # b=0 divides
    with pytest.raises(ZeroDivisionError):
        list(it)


def test_abandoned_iterator_ends_its_thread():
    """A consumer that stops early closes the iterator: the staging thread
    ends instead of blocking on a full queue."""
    before = threading.active_count()
    it = prefetch.prefetch_to_device(iter(range(1000)), lambda b: b, depth=1)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_device_put_on_the_cpu():
    """On the CPU the staged batch is the arrays as tensors, the keys asked
    for alone, ``None`` kept, in loader order."""
    rs = np.random.RandomState(0)
    batches = [{"images": rs.rand(2, 3, 4).astype(np.float32),
                "labels": rs.rand(2, 3).astype(np.float32),
                "globals": None, "case_id": np.arange(2)} for _ in range(3)]
    put = prefetch.DevicePut(torch.device("cpu"),
                             ("images", "labels", "globals"))
    got = [s.wait() for s in prefetch.prefetch_to_device(batches, put)]
    assert len(got) == 3
    for g, b in zip(got, batches):
        assert set(g) == {"images", "labels", "globals"}
        assert g["globals"] is None
        np.testing.assert_array_equal(g["images"].numpy(), b["images"])
        np.testing.assert_array_equal(g["labels"].numpy(), b["labels"])
