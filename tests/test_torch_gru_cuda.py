"""The GRU gate kernels (``csrc/gru_gates.cu`` through ``ops/gru.py``)
against the chain of torch ops they replace, on the card.

Marked ``cuda_hardware``: every test skips where ``torch.cuda.is_available()``
is False (the CPU gate).  On a card:

    python -m pytest --noconftest -q tests/test_torch_gru_cuda.py

Shapes: the DialogueRNN scan's three cells at B = 30, both directions
batched (X = 2): ``g_cell`` gi (2, 30, 1500), h (2, 30, 500); ``p_cell`` gi
(2, 30, 1, 1500), h (2, 30, 2, 500), its input broadcast over the two
parties; ``e_cell`` gi (2, 30, 300), h (2, 30, 100).  The chain runs on the
card too (``ops.gru.gru_gates_plain`` and its autograd), at float32 and at
bfloat16.  The kernels round where the chain's ops round, so the forward
gives the chain's bits at both dtypes, and so does the backward (dgi, dgh
and the direct part of dh): each is asserted bit for bit, after
``torch.testing.assert_close`` at rtol 1e-5 (f32) or 2^-8 (bf16), which
names the worst element where the bits part.
"""

import numpy as np
import pytest
import torch

from gan_ffn_tpu_torch.models import dialogue_rnn as TD
from gan_ffn_tpu_torch.nn import recurrent as R
from gan_ffn_tpu_torch.ops import gru as G

pytestmark = pytest.mark.cuda_hardware

# cell -> (gi shape, h shape)
CELLS = {
    "g_cell": ((2, 30, 1500), (2, 30, 500)),
    "p_cell": ((2, 30, 1, 1500), (2, 30, 2, 500)),
    "e_cell": ((2, 30, 300), (2, 30, 100)),
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cell, dtype, device, seed=0):
    """gi, gh (projections with their bias, about N(0, 1)), h in (-1, 1) and
    dout, from numpy."""
    rng = np.random.default_rng(seed)
    gi_shape, h_shape = CELLS[cell]
    gh_shape = (*h_shape[:-1], 3 * h_shape[-1])

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)

    return (t(rng.standard_normal(gi_shape)), t(rng.standard_normal(gh_shape)),
            t(np.tanh(rng.standard_normal(h_shape))), t(0.1 * rng.standard_normal(h_shape)))


def _chain_grads(gi, gh, h, dout):
    leaves = [x.clone().requires_grad_(True) for x in (gi, gh, h)]
    return torch.autograd.grad(G.gru_gates_plain(*leaves), leaves, dout)


def _same_bits(got, want, what):
    tol = dict(rtol=1e-5, atol=0.0) if got.dtype == torch.float32 else dict(rtol=2**-8, atol=0.0)
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{what}: {m}")
    assert torch.equal(got, want), f"{what}: {int((got != want).sum())} elements differ"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_forward_gives_the_chains_bits(cuda, cell, dtype):
    gi, gh, h, _ = _operands(cell, dtype, cuda)
    before = G.gru_gates.launches
    got = G.gru_gates(gi, gh, h)
    assert G.gru_gates.launches == before + 1
    torch.cuda.synchronize()
    _same_bits(got, G.gru_gates_plain(gi, gh, h), "h'")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_backward_gives_the_chains_autograd(cuda, cell, dtype):
    """dgi (summed over the parties in ``p_cell``), dgh and dh, through
    autograd of :func:`ops.gru.gru_gates`, against autograd of the chain."""
    gi, gh, h, dout = _operands(cell, dtype, cuda, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (gi, gh, h)]
    before = G.gru_gates_backward.launches
    got = torch.autograd.grad(G.gru_gates(*leaves), leaves, dout)
    assert G.gru_gates_backward.launches == before + 1
    torch.cuda.synchronize()
    for name, g, w in zip(("dgi", "dgh", "dh"), got, _chain_grads(gi, gh, h, dout)):
        assert g.shape == w.shape
        _same_bits(g, w, name)


def test_kernels_replay_in_a_cuda_graph(cuda):
    """Both kernels captured in one graph (the ``p_cell`` shape) and replayed
    on new operands copied into its static inputs: the chain's bits.  A
    recorded call is not counted, and a replay calls no wrapper."""
    static = _operands("p_cell", torch.float32, cuda, seed=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the libraries load before the capture
        G.gru_gates(*static[:3])
        G.gru_gates_backward(*static)
    torch.cuda.current_stream().wait_stream(side)
    counts = G.gru_gates.launches, G.gru_gates_backward.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = G.gru_gates(*static[:3])
        grads = G.gru_gates_backward(*static)
    for seed in (3, 4):
        fresh = _operands("p_cell", torch.float32, cuda, seed=seed)
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(out, G.gru_gates_plain(*fresh[:3]), "h'")
        for name, g, w in zip(("dgi", "dgh", "dh"), grads, _chain_grads(*fresh)):
            _same_bits(g, w, name)
    assert (G.gru_gates.launches, G.gru_gates_backward.launches) == counts


def test_an_eager_scan_launches_each_kernel_three_times_a_step(cuda, monkeypatch):
    """A BiModel train step of length L (both directions in one scan, no
    listener state): 3 L forward launches, one for each of the g, p and e
    cells a step, and 3 L - 1 backward: the last step's g enters only the
    history, which no later step reads, so autograd runs no backward for it
    (nor did it for the chain's ops).  In eval mode the outputs are those of
    the chain, bit for bit."""
    torch.manual_seed(0)
    L, B, D_m, D_g, D_p, D_e, D_h = 7, 3, 20, 16, 16, 8, 16
    gen = torch.Generator(device="cpu").manual_seed(5)
    model = TD.BiModel(D_m, D_g, D_p, D_e, D_h, 6, context_attention="general",
                       generator=gen, device="cpu").to(cuda)
    U = torch.randn(L, B, D_m, device=cuda)
    qmask = torch.nn.functional.one_hot(torch.randint(0, 2, (L, B)), 2).float().to(cuda)
    umask = torch.ones(B, L, device=cuda)
    G.gru_gates.launches = G.gru_gates_backward.launches = 0
    model.train()
    model(U, qmask, umask)[0].sum().backward()
    assert (G.gru_gates.launches, G.gru_gates_backward.launches) == (3 * L, 3 * L - 1)
    model.eval()
    with torch.no_grad():
        got = model(U, qmask, umask)
        monkeypatch.setattr(R, "gru_gates", G.gru_gates_plain)
        want = model(U, qmask, umask)
    for name, g, w in zip(("log_prob", "alpha", "alpha_f", "alpha_b"), got, want):
        assert torch.equal(g, w), name
