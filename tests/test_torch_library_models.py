"""The port's library-only models against the JAX package's, on the CPU: the
eight baselines of ``models/baselines.py``, ``nn/attention.Attention`` (its
four score functions) and ``matching``.

Each JAX module runs once per model and configuration (one jitted
``value_and_grad``, forward and gradients from the same apply, on the
port's parameters: ``tests/jax_parity.py::hold``, which also checks the
weight bridge both ways against the JAX module's own tree).  Inputs come from numpy with a seed.  Forwards are held to rtol/atol 1e-5
and every parameter's gradient to 1e-4 (the LSTM family's limits,
tests/test_torch_meld.py): the same f32 math, summed in other orders.  The
file runs torch on one intra-op thread.
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch
from jax_parity import hold

from gan_ffn_tpu import models as JM
from gan_ffn_tpu.nn import Attention as JaxAttention
from gan_ffn_tpu.nn import MatchingAttention as JaxMatchingAttention
from gan_ffn_tpu.nn import matching as jax_matching
from gan_ffn_tpu.nn.core import TorchLinear
from gan_ffn_tpu.nn.recurrent import LSTM as JaxLSTM
from gan_ffn_tpu_torch import models as PM
from gan_ffn_tpu_torch.nn import Attention, MatchingAttention, matching

L, B = 6, 3
LENGTHS = np.array([6, 4, 2])  # padded tails under umask


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feats(seed, *dims, length=L):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((length, B, d)).astype(np.float32) for d in dims]


def _umask(length=L):
    return (np.arange(length)[None, :] < LENGTHS[:, None]).astype(np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int64)


def _g(seed=0):
    return dict(generator=torch.Generator().manual_seed(seed), device="cpu")


# (a) Attention and matching


@pytest.mark.parametrize("score_function", ["dot_product", "scaled_dot_product", "mlp", "bi_linear"])
def test_attention_score_functions_match_jax(score_function):
    """Batch-first k and q of different lengths, softmax over axis 0."""
    rng = np.random.default_rng(1)
    k, q = rng.standard_normal((B, 5, 24)).astype(np.float32), rng.standard_normal(
        (B, 4, 24)).astype(np.float32)
    port = Attention(24, n_head=4, score_function=score_function, **_g(1))
    jm = JaxAttention(24, n_head=4, score_function=score_function)
    hold(port, jm, [k, q], eager=True)
    with torch.no_grad():  # the score comes back too, softmaxed over axis 0
        _, score = port(torch.from_numpy(k), torch.from_numpy(q))
    assert score.shape == (4 * B, 4, 5)
    torch.testing.assert_close(score.sum(0), torch.ones(4, 5))


def test_attention_takes_2d_inputs_and_trains_with_dropout():
    """2-D k and q get a length of 1; in training mode the output's dropout
    is torch's at the module's rate, none in eval mode."""
    rng = np.random.default_rng(2)
    k, q = rng.standard_normal((B, 24)).astype(np.float32), rng.standard_normal(
        (B, 24)).astype(np.float32)
    port = Attention(24, n_head=4, **_g(2))
    hold(port, JaxAttention(24, n_head=4), [k, q])
    port.train()
    torch.manual_seed(0)
    out, _ = port(torch.from_numpy(k), torch.from_numpy(q))
    with torch.no_grad():
        ref = port.eval()(torch.from_numpy(k), torch.from_numpy(q))[0]
    kept = out != 0
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(out[kept], ref[kept] / (1 - 0.6))


def test_matching_matches_jax():
    """``matching`` through a general2 ``MatchingAttention`` over a ragged
    umask: the pool of every step of ``modal`` plus gelu(emotions)."""
    emotions, modal = _feats(3, 12, 12)
    um = _umask()
    port = MatchingAttention(12, 12, att_type="general2", **_g(3))

    class JaxMatching(flax_nn.Module):
        @flax_nn.compact
        def __call__(self, M, x, mask):
            att = JaxMatchingAttention(12, 12, att_type="general2", name="matchatt")
            return jax_matching(lambda a, b, c: att(a, b, c), M, x, mask)

    class PortMatching(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.matchatt = port

        def forward(self, M, x, mask):
            return matching(self.matchatt, M, x, mask)

    wants = hold(PortMatching(), JaxMatching(), [emotions, modal, um])
    assert wants[0].shape == (L, B, 12) and wants[1].shape == (L, B, 1, L)


# (b) the baselines


@pytest.mark.parametrize("attention", [False, True])
def test_lstm_model2_matches_jax(attention):
    (U,) = _feats(4, 20)
    port = PM.LSTMModel2(20, 8, 12, n_classes=6, attention=attention, **_g(4))
    jm = JM.LSTMModel2(D_m=20, D_e=8, D_h=12, n_classes=6, attention=attention)
    wants = hold(port, jm, [U, None, _umask()])
    assert len(wants) == 4 and (wants[1].shape == (L, B, L) if attention else wants[1] == [])


def test_lstm_model_matches_jax():
    """The visual slice [:, :, :100] and Attention(600) over a time-major
    tensor taken as batch-first."""
    t, a, v = _feats(5, 100, 100, 512)
    port = PM.LSTMModel(100, 100, 100, n_classes=6, **_g(5))
    jm = JM.LSTMModel(D_m=100, D_e=100, D_h=100, n_classes=6)
    wants = hold(port, jm, [t, a, v, None, _umask()])
    assert len(wants) == 5 and wants[4].shape == (L, B, 600)  # the hidden state comes back too


def test_cnn_matches_jax():
    (t,) = _feats(6, 100)
    port = PM.CNN(100, 16, (2, 3, 4), 6, **_g(6))
    jm = JM.CNN(embedding_dim=100, num_filter=16, filter_sizes=(2, 3, 4), output_dim=6)
    wants = hold(port, jm, [t, None, None])
    assert wants[0].shape == (B, 6) and wants[4].shape == (B, 48)


def test_textcnn_matches_jax():
    """Raw logits; only the first sentence_max_size - k + 1 windows pool."""
    (x,) = _feats(7, 100, length=9)
    port = PM.TextCNN(sentence_max_size=7, label_num=6, **_g(7))
    (want,) = hold(port, JM.TextCNN(sentence_max_size=7, label_num=6), [x])
    assert want.shape == (B, 6)


def test_fully_connection_matches_jax():
    (x,) = _feats(8, 100)
    (want,) = hold(PM.FullyConnection(**_g(8)), JM.FullyConnection(), [x])
    assert want.shape == (L, B, 2048)


def test_emoformer_matches_jax():
    """The attention=False path at its published widths (text and audio
    100, visual 512): shared norm_1, attention_3 at D_m + 412."""
    t, a, v = _feats(9, 100, 100, 512)
    port = PM.Emoformer(100, 30, n_classes=6, **_g(9))
    jm = JM.Emoformer(D_m=100, D_e=30, n_classes=6)
    wants = hold(port, jm, [t, a, v, None, _umask()])
    assert wants[1] == [] and wants[4].shape == (L, B, 60)
    assert port.norm_1.weight.shape == (100,) and port.attention_3.w_k.weight.shape == (512, 512)


def test_emoformer_attention_path_matches_jax_and_raises_as_jax_does():
    """attention=True adds the 2048-wide matching output to the D_m-wide
    text: at the published widths both packages raise.  Its fusion (the 3
    x 3 matching loop through one shared MatchingAttention(2048), then
    transform2 and lstm_1) is held to the same JAX modules composed as the
    JAX Emoformer composes them, with a 2048-wide text where the sum
    broadcasts."""
    t, a, v = _feats(10, 100, 100, 512)
    um = _umask()
    jm = JM.Emoformer(D_m=100, D_e=8, n_classes=6, attention=True)
    with pytest.raises(TypeError):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), t, a, v, None, um)
    port = PM.Emoformer(100, 8, n_classes=6, attention=True, **_g(10))
    with pytest.raises(RuntimeError, match="2048"):
        port.eval()(*(torch.from_numpy(x) for x in (t, a, v)), None, torch.from_numpy(um))

    class JaxFuse(flax_nn.Module):
        """gan_ffn_tpu/models/baselines.py Emoformer's attention=True branch."""

        @flax_nn.compact
        def __call__(self, textf_u, textf, acouf, visuf, umask):
            matchatt = JaxMatchingAttention(2048, 2048, att_type="general2", name="matchatt")
            emotions = [textf, acouf, visuf]
            output = 0.0
            for i in emotions:
                for j in emotions:
                    hid, alpha = jax_matching(lambda M, x, m: matchatt(M, x, m), i, j, umask)
                    output = output + hid
            output, _ = JaxLSTM(hidden_size=8, num_layers=2, bidirectional=True, dropout=0.5,
                                name="lstm_1")(TorchLinear(16, name="transform2")(output + textf_u))
            return output, alpha

    class PortFuse(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.matchatt, self.transform2, self.lstm_1 = (port.matchatt, port.transform2,
                                                           port.lstm_1)

        def forward(self, *args):
            return PM.Emoformer.fuse(port, *args)

    wants = hold(PortFuse(), JaxFuse(), _feats(11, 2048, 2048, 2048, 2048) + [um])
    assert wants[1].shape == (L, B, 1, L)  # the last matching's weights


def test_cnn_feature_extractor_matches_jax():
    """Conv1d on the channels-first transpose, VALID windows, masked by
    umask.T: padded utterances give exactly 0."""
    tokens = _tokens(12, (L, B, 9), 40)
    um = _umask()
    port = PM.CNNFeatureExtractor(40, embedding_dim=16, output_size=12, filters=8, **_g(12))
    jm = JM.CNNFeatureExtractor(40, embedding_dim=16, output_size=12, filters=8)
    (want,) = hold(port, jm, [tokens, um])
    assert np.all(np.asarray(want)[um.T == 0] == 0)


@pytest.mark.parametrize("attention", [False, True])
def test_e2e_lstm_model_matches_jax(attention):
    tokens = _tokens(13, (L, B, 9), 40)
    kw = dict(D_e=10, D_h=14, vocab_size=40, embedding_dim=16, cnn_output_size=12,
              cnn_filters=8, n_classes=6, attention=attention)
    port = PM.E2ELSTMModel(**kw, **_g(13))
    hold(port, JM.E2ELSTMModel(**kw), [tokens, None, _umask()])
