"""The port's modules (gan_ffn_tpu_torch.nn / .models) against the JAX package.

JAX weights are carried into the port by ``gan_ffn_state_dict_from_jax``;
the JAX side runs its XLA paths (conftest sets ``GANFFN_PALLAS=0``).  Inputs
are made by numpy from a seed, at L=8, B=2 with valid_len=6 so that the key
mask is exercised.  Tolerance: atol 1e-4 on outputs after up to 2 encoder
layers and the head, where the two frameworks sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.models import AcousticGenerator as JaxAcoustic
from gan_ffn_tpu.models import TextGenerator as JaxText
from gan_ffn_tpu.models import VisualGenerator as JaxVisual
from gan_ffn_tpu.nn.transformer import TransformerEncoder as JaxEncoder
from gan_ffn_tpu.nn.transformer import TransformerEncoderLayer as JaxEncoderLayer
from gan_ffn_tpu.nn.core import gelu as jax_gelu
from gan_ffn_tpu.nn.transformer import stack_layer_params
from gan_ffn_tpu_torch.models import GAN_FFN, AcousticGenerator, TextGenerator, VisualGenerator
from gan_ffn_tpu_torch.nn.core import gelu, set_dropout_generator
from gan_ffn_tpu_torch.nn.positional import PositionalEncoding, sinusoidal_table
from gan_ffn_tpu_torch.nn.transformer import TransformerEncoder, TransformerEncoderLayer
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax
from torch_mapping import encoder_params, linear_params

L, B, VL = 8, 2, 6
ATOL = 1e-4


def _x(d, seed):
    return np.random.default_rng(seed).standard_normal((L, B, d)).astype(np.float32)


def _jax_init(module, *inputs):
    return module.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))["params"]


def _port(module, params):
    module.load_state_dict(gan_ffn_state_dict_from_jax(params))
    return module.eval()


CASES = {
    "encoder_layer": (
        lambda: JaxEncoderLayer(100, 10),
        lambda: TransformerEncoderLayer(100, 10, device="cpu"),
        (100,),
    ),
    "encoder_2_layers_visual": (
        lambda: JaxEncoder(512, 8, num_layers=2),
        lambda: TransformerEncoder(512, 8, num_layers=2, device="cpu"),
        (512,),
    ),
    "acoustic_generator": (
        lambda: JaxAcoustic(D_h=100, num_layers=2),
        lambda: AcousticGenerator(100, num_layers=2, device="cpu"),
        (100,),
    ),
    "visual_generator": (
        lambda: JaxVisual(D_h=100, num_layers=2),
        lambda: VisualGenerator(100, num_layers=2, device="cpu"),
        (512,),
    ),
    "text_generator": (
        lambda: JaxText(D_h=100, num_layers=2),
        lambda: TextGenerator(100, num_layers=2, device="cpu"),
        (100,),
    ),
    "gan_ffn": (
        lambda: JaxGAN_FFN(n_classes=6, gen_num_layers=2),
        lambda: GAN_FFN(n_classes=6, gen_num_layers=2, device="cpu"),
        (100, 512, 100),
    ),
}


@pytest.mark.parametrize("name", list(CASES))
def test_module_matches_jax(name):
    make_jax, make_port, dims = CASES[name]
    xs = [_x(d, seed) for seed, d in enumerate(dims)]
    jm = make_jax()
    params = _jax_init(jm, *xs)
    out = jm.apply({"params": params}, *(jnp.asarray(a) for a in xs),
                   valid_len=jnp.int32(VL), deterministic=True)
    want = np.asarray(out[0] if isinstance(out, tuple) else out)
    with torch.inference_mode():
        got = _port(make_port(), params)(*(torch.from_numpy(a) for a in xs), valid_len=VL)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_scanned_layout_converts_to_the_same_state_dict():
    _, _, dims = CASES["gan_ffn"]
    params = _jax_init(CASES["gan_ffn"][0](), *(_x(d, 0) for d in dims))
    unrolled = gan_ffn_state_dict_from_jax(params)
    scanned = gan_ffn_state_dict_from_jax(jax.tree.map(np.asarray, stack_layer_params(params)))
    assert set(scanned) == set(unrolled)
    for k in unrolled:
        torch.testing.assert_close(scanned[k], unrolled[k], rtol=0, atol=0)


def test_bridge_round_trip_is_identity():
    """port module -> JAX tree (tests/torch_mapping.py) -> bridge -> port."""
    model = GAN_FFN(gen_num_layers=2, generator=torch.Generator().manual_seed(3), device="cpu")

    def generator_tree(g):
        net = g.net
        return {"net": {
            "transformer_encoder": encoder_params(net.transformer_encoder),
            "fc1": linear_params(net.fc1),
            "fc2": linear_params(net.fc2),
        }}

    tree = {
        "acoustic_generator": generator_tree(model.acoustic_generator),
        "visual_generator": generator_tree(model.visual_generator),
        "text_generator": generator_tree(model.text_generator),
        "fc": linear_params(model.fc),
    }
    back = gan_ffn_state_dict_from_jax(tree)
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_gelu_is_the_exact_erf_gelu():
    # the two frameworks' float32 erf differ by < 1e-6 near zero: the
    # tolerance of tests/test_pallas_ops.py
    x = np.linspace(-8.0, 8.0, 1001, dtype=np.float32)
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_gelu(jnp.asarray(x))), rtol=2e-5, atol=2e-6)


def test_positional_table_and_length_guard():
    for d in (100, 7):  # odd d: the cos half is one column shorter
        pe = PositionalEncoding(d, max_len=128, device="cpu").eval()
        x = torch.zeros(5, 1, d)
        np.testing.assert_array_equal(pe(x).numpy(), sinusoidal_table(128, d)[:5])
    with pytest.raises(ValueError, match="exceeds max_len"):
        pe(torch.zeros(129, 1, 7))


def test_init_is_seeded_and_device_explicit():
    a = GAN_FFN(gen_num_layers=1, generator=torch.Generator().manual_seed(0), device="cpu")
    b = GAN_FFN(gen_num_layers=1, generator=torch.Generator().manual_seed(0), device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    # torch's default Linear init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    w = a.acoustic_generator.net.transformer_encoder.layers[0].linear1.weight
    assert w.abs().max().item() <= 100 ** -0.5
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            GAN_FFN(gen_num_layers=1)


def test_positional_dropout_keeps_the_jax_rate():
    """The JAX generator builds its PositionalEncoding without a rate, so its
    PE dropout is the module default 0.2 whatever the generator's dropout."""
    for cls in (AcousticGenerator, VisualGenerator, TextGenerator):
        gen = cls(100, dropout=0.5, num_layers=1, device="cpu")
        assert gen.net.position_encoding.dropout == 0.2
        assert gen.net.dropout == 0.5


def test_training_mode_is_seeded_by_the_dropout_generator():
    """In training mode the kernel dropouts draw their seeds from the model's
    dropout generator and the others from torch's RNG: the same seeds give
    the same log-probs, another kernel seed gives others."""
    model = GAN_FFN(gen_num_layers=1, generator=torch.Generator().manual_seed(0), device="cpu")
    xs = [torch.from_numpy(_x(d, 0)) for d in (100, 512, 100)]

    def run(kernel_seed):
        set_dropout_generator(model, torch.Generator().manual_seed(kernel_seed))
        torch.manual_seed(1)
        with torch.no_grad():
            return model.train()(*xs, valid_len=VL)

    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with torch.no_grad():
        assert not torch.equal(a, model.eval()(*xs, valid_len=VL))
