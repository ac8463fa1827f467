"""The port's AVEC and DailyDialog data (``data/datasets.py``,
``data/loaders.py``, ``data/synthetic.py``) against the JAX package's, on
the CPU: from the same arguments and seed the writers write the same
pickle bytes, and the datasets and loaders give identical items and
batches, epoch after epoch."""

import dataclasses

import numpy as np
import pytest

from gan_ffn_tpu import data as JD
from gan_ffn_tpu_torch import data as PD


def _same(got, want, what=""):
    """Two dataclass instances (items or batches) field by field, arrays in
    dtype, shape and value."""
    assert type(got).__name__ == type(want).__name__, what
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, (what, f.name)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f.name}")
        else:
            assert g == w, (what, f.name)


@pytest.fixture(scope="module")
def avec(tmp_path_factory):
    root = tmp_path_factory.mktemp("avec")
    kw = dict(n_train=14, n_test=5, max_len=60, seed=11)
    return (PD.write_synthetic_avec(str(root / "port.pkl"), **kw),
            JD.write_synthetic_avec(str(root / "jax.pkl"), **kw))


@pytest.fixture(scope="module")
def dailydialog(tmp_path_factory):
    root = tmp_path_factory.mktemp("dd")
    kw = dict(n_train=13, n_test=5, n_valid=4, max_len=20, max_tokens=12, seed=12)
    return (PD.write_synthetic_dailydialogue(str(root / "port.pkl"), **kw),
            JD.write_synthetic_dailydialogue(str(root / "jax.pkl"), **kw))


@pytest.mark.parametrize("fixture", ["avec", "dailydialog"])
def test_writers_write_the_jax_bytes(fixture, request):
    port, jax = request.getfixturevalue(fixture)
    with open(port, "rb") as f, open(jax, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("train", [True, False])
def test_avec_dataset_matches_jax(avec, train):
    """Float labels, 'user' / 'other' speakers, no normalization."""
    port, jax = PD.AVECDataset(avec[0], train=train), JD.AVECDataset(avec[0], train=train)
    assert len(port) == len(jax) == (14 if train else 5)
    for i in range(len(jax)):
        _same(port[i], jax[i], f"item {i}")
    assert port[0].label.dtype == np.float32 and port.n_parties == 2


def test_avec_loaders_match_jax(avec):
    """(train, valid, test) over buckets (32, 64), two epochs of shuffles."""
    port, jax = PD.get_avec_loaders(avec[0], batch_size=4), JD.get_avec_loaders(avec[0], batch_size=4)
    assert port[0].buckets == (32, 64)
    for name, p, j in zip(("train", "valid", "test"), port, jax):
        assert len(p) == len(j)
        for epoch in range(2):
            pb, jb = list(p), list(j)
            assert len(pb) == len(jb) == len(j)
            for k, (a, b) in enumerate(zip(pb, jb)):
                _same(a, b, f"{name} epoch {epoch} batch {k}")


@pytest.mark.parametrize("split", ["train", "test", "valid"])
def test_dailydialogue_dataset_matches_jax(dailydialog, split):
    port = PD.DailyDialogueDataset(dailydialog[0], split=split)
    jax = JD.DailyDialogueDataset(dailydialog[0], split=split)
    assert len(port) == len(jax) == {"train": 13, "test": 5, "valid": 4}[split]
    for i in range(len(jax)):
        _same(port[i], jax[i], f"{split} item {i}")


def test_dailydialogue_loaders_match_jax(dailydialog):
    """(train, test, valid), in that order: token batches, the train
    loader's shuffle by (seed, epoch)."""
    kw = dict(batch_size=4, buckets=(8, 16, 24), max_tokens=12, seed=5)
    port = PD.get_dailydialogue_loaders(dailydialog[0], **kw)
    jax = JD.get_dailydialogue_loaders(dailydialog[0], **kw)
    assert [len(p.dataset) for p in port] == [13, 5, 4]
    assert [p.shuffle for p in port] == [True, False, False]
    for name, p, j in zip(("train", "test", "valid"), port, jax):
        for epoch in range(2):
            pb, jb = list(p), list(j)
            assert len(pb) == len(jb) == len(p)
            for k, (a, b) in enumerate(zip(pb, jb)):
                _same(a, b, f"{name} epoch {epoch} batch {k}")
    first = next(iter(PD.get_dailydialogue_loaders(dailydialog[0], **kw)[0]))
    assert first.tokens.shape[1:] == (4, 12) and first.tokens.dtype == np.int32


def test_collate_token_dialogues_matches_jax(dailydialog):
    """A partial batch padded to (bucket, batch_size, max_tokens)."""
    items_p = [PD.DailyDialogueDataset(dailydialog[0])[i] for i in (0, 3)]
    items_j = [JD.DailyDialogueDataset(dailydialog[0])[i] for i in (0, 3)]
    _same(PD.collate_token_dialogues(items_p, 24, 4, 12),
          JD.loaders.collate_token_dialogues(items_j, 24, 4, 12))
