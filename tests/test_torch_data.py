"""repro_torch.data against repro.data: every array equal.

Both packages are numpy here, so the same seeds must give the same
bytes: images, labels, minibatch order, partitions and token streams.
"""
import numpy as np
import pytest

from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.data import tokens as jtokens
from repro_torch.data import partition as tpartition
from repro_torch.data import synthetic as tsynthetic
from repro_torch.data import tokens as ttokens


@pytest.mark.parametrize("kw", [
    dict(n=64, size=8, seed=0),
    dict(n=50, size=16, noise=1.0, seed=99, channels=1, num_classes=4),
    dict(n=7, size=32, noise=0.0, seed=3, template_seed=5),
])
def test_make_image_dataset_equal(kw):
    n = kw.pop("n")
    want = jsynthetic.make_image_dataset(n, **kw)
    got = tsynthetic.make_image_dataset(n, **kw)
    for a, b in ((got.images, want.images), (got.labels, want.labels)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    idx = np.array([3, 0, 5])
    np.testing.assert_array_equal(got.subset(idx).images,
                                  want.subset(idx).images)
    assert len(got) == len(want) == n


@pytest.mark.parametrize("batch,epochs", [(16, 1), (5, 3)])
def test_batches_equal(batch, epochs):
    ds = jsynthetic.make_image_dataset(33, size=8, seed=1)
    tds = tsynthetic.SyntheticImageDataset(ds.images, ds.labels)
    want = list(jsynthetic.batches(ds, batch, seed=4, epochs=epochs))
    got = list(tsynthetic.batches(tds, batch, seed=4, epochs=epochs))
    assert len(got) == len(want) == epochs * (33 // batch)
    for (x, y), (xw, yw) in zip(got, want, strict=True):
        np.testing.assert_array_equal(x, xw)
        np.testing.assert_array_equal(y, yw)


@pytest.mark.parametrize("clients", [3, 10])
def test_partitions_and_weights_equal(clients):
    labels = jsynthetic.make_image_dataset(200, size=8, seed=2).labels
    for fn in ("iid_partition", "mixed_noniid_partition"):
        want = getattr(jpartition, fn)(labels, clients, seed=1)
        got = getattr(tpartition, fn)(labels, clients, seed=1)
        assert len(got) == len(want) == clients
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        w = tpartition.client_weights(got)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, jpartition.client_weights(want))


def test_token_stream_equal():
    want = jtokens.make_token_stream(97, seed=3)
    got = ttokens.make_token_stream(97, seed=3)
    np.testing.assert_array_equal(got.sample(4, 9), want.sample(4, 9))
    bw, bg = want.batch(2, 5), got.batch(2, 5)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(bg[key], bw[key])
