"""A whole run of each cell on the CPU, with the port's step broken
underneath, comes out not correct: once for each fault a single-card
training cell can have (no exchange between cards here)."""

import pytest
import torch

import gan_ffn_tpu_torch.train.classifier as port_classifier
import gan_ffn_tpu_torch.train.gan as port_gan

from .tiny import CELLS, run_tiny


def _assert_caught(result):
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    _assert_caught(run_tiny(cell))


def test_stage_a_half_batch(monkeypatch):
    real = port_gan.duel_mask

    def half(batch):
        m = real(batch).clone()
        m[:, m.shape[1] // 2:] = 0.0
        return m

    monkeypatch.setattr(port_gan, "duel_mask", half)
    _assert_caught(run_tiny(CELLS[0]))


def test_classifier_half_batch(monkeypatch):
    real = port_classifier.loss_and_preds

    def half(log_prob, batch, *args, **kw):
        umask = batch["umask"].clone()
        umask[umask.shape[0] // 2:] = 0.0
        return real(log_prob, {**batch, "umask": umask}, *args, **kw)

    monkeypatch.setattr(port_classifier, "loss_and_preds", half)
    _assert_caught(run_tiny(CELLS[1]))


def _altered_stage_a(run):
    def step(tensors):
        out = dict(run(tensors))
        out["duel_0"] = out["duel_0"] * (1.0 + 1e-3)
        return out
    return step


def _altered_classifier(run):
    def step(tensors):
        loss, preds = run(tensors)
        return loss * (1.0 + 1e-3), preds
    return step


@pytest.mark.parametrize("cell,fault", [(CELLS[0], _altered_stage_a),
                                        (CELLS[1], _altered_classifier)])
def test_answer_altered_where_it_is_produced(cell, fault):
    _assert_caught(run_tiny(cell, fault_run=fault))
