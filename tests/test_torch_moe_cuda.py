"""The grouped SwiGLU expert kernels (``csrc/moe_ffn.cu`` through
``ops/moe.py``) and the MoE layer (``nn/moe.py``) on the card, against the
plain loop over the groups (``ops.moe.grouped_swiglu_plain``, cuBLAS
float32 with TF32 off).

Marked ``cuda_hardware``: every test skips where ``torch.cuda.is_available()``
is False.  On a card:

    python -m pytest --noconftest -q tests/test_torch_moe_cuda.py

Shapes are Moonlight-16B-A3B's (hidden 2048): the routed experts (64 of
1,408, each of 3,584 rows to 6 of them, a fifth of the rows unrouted), the
shared experts as one group of 2,816 and the dense layer's SwiGLU of
11,264, each over 3,584 rows.

Tolerance: every output within ``TOL = 2e-5`` of ``max |ref|`` of the
loop's.  Against float64 on the H100, the kernels' outputs and gradients
read at most 2.1e-6 of their largest (3xTF32 products, ~2^-21 each, every
8-deep k step added in round-to-nearest) and cuBLAS f32's at most 2.1e-6,
so the two sides differ by a few 1e-6; one TF32 pass (10-bit mantissas)
reads 4.5e-4 to 6.7e-4.  2e-5 lies ten times above the first and twenty
below the second: ``test_tf32_products_fail_the_tolerance`` holds the loop
with TF32 products to it and expects a failure.
"""

import pytest
import torch

from gan_ffn_tpu_torch.nn import moe as M
from gan_ffn_tpu_torch.ops import moe as O

pytestmark = pytest.mark.cuda_hardware

TOL = 2e-5  # of max |ref|: see the module docstring
H, E, K, F_ROUTED, F_SHARED, F_DENSE, N = 2048, 64, 6, 1408, 2816, 11264, 3584


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(n, width, device, seed, hidden=H):
    g = torch.Generator(device=device).manual_seed(seed)
    wg = torch.rand(n, width, hidden, generator=g, device=device).sub_(0.5).mul_(2 / hidden ** 0.5)
    wu = torch.rand(n, width, hidden, generator=g, device=device).sub_(0.5).mul_(2 / hidden ** 0.5)
    wd = torch.rand(n, hidden, width, generator=g, device=device).sub_(0.5).mul_(2 / width ** 0.5)
    return wg, wu, wd


def _routing(device, seed, groups=E, rows=N, top_k=K, one_expert=False, empty=()):
    """Rows sorted by group for ``rows`` rows of ``top_k`` choices each,
    the last fifth of the rows unrouted."""
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.rand(rows, groups, generator=g, device=device)
    if empty:
        scores[:, list(empty)] = -1.0
    idx = scores.topk(top_k, dim=-1).indices
    if one_expert:
        idx[:, 0] = 3
    valid = torch.arange(rows, device=device) < int(0.8 * rows)
    order, counts, offsets, inv, src = M.sort_pairs(idx, valid, groups)
    w = torch.rand(rows * top_k, generator=g, device=device)[order]
    return src, offsets, w


def _close(got, want, tol=TOL):
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    return err, err <= tol


def _case(device, width, groups, seed, hidden=H, rows=N, **routing):
    wg, wu, wd = _weights(groups, width, device, seed, hidden)
    x0 = torch.randn(rows, hidden, device=device,
                     generator=torch.Generator(device=device).manual_seed(7))
    if groups == 1:
        x, offsets, w = x0, None, None
    else:
        src, offsets, w = _routing(device, seed, groups, rows, **routing)
        x = x0[src]
    return x, offsets, w, wg, wu, wd


def _both(x, offsets, w, wg, wu, wd):
    """(kernel, loop) outputs and gradients, the rows of groups only."""
    total = x.shape[0] if offsets is None else int(offsets[-1])
    dy = torch.randn(*x.shape, device=x.device,
                     generator=torch.Generator(device=x.device).manual_seed(5))
    out = []
    for fn in (O.grouped_swiglu, O.grouped_swiglu_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, wg, wu, wd)]
        wt = w.detach().clone().requires_grad_(True) if w is not None else None
        y = fn(leaves[0], *leaves[1:], offsets, wt)
        grads = torch.autograd.grad(y[:total], leaves + ([wt] if wt is not None else []),
                                    dy[:total])
        out.append([y[:total]] + [grads[0][:total]] + list(grads[1:4])
                   + ([grads[4][:total]] if wt is not None else []))
    return out


@pytest.mark.parametrize("kind", ["routed", "shared", "dense", "empty_experts", "one_expert",
                                  "small_ragged"])
def test_grouped_swiglu_matches_the_loop(cuda, kind):
    # small_ragged: widths and row counts that are no multiple of the 64-wide
    # tiles, and a weight-gradient grid far below a wave (5 x 3 x 3 tiles)
    width, groups, routing = {"routed": (F_ROUTED, E, {}), "shared": (F_SHARED, 1, {}),
                              "dense": (F_DENSE, 1, {}),
                              "empty_experts": (F_ROUTED, E, {"empty": (0, 5, 63)}),
                              "one_expert": (F_ROUTED, E, {"one_expert": True}),
                              "small_ragged": (72, 5, {"hidden": 160, "rows": 301,
                                                       "top_k": 2})}[kind]
    args = _case(cuda, width, groups, 11, **routing)
    kernel, loop = _both(*args)
    names = ["y", "dx", "dw_gate", "dw_up", "dw_down", "dweights"]
    errs = {n: _close(k, r)[0] for n, k, r in zip(names, kernel, loop)}
    print(kind, errs)
    assert all(e <= TOL for e in errs.values()), errs


def test_tf32_products_fail_the_tolerance(cuda):
    args = _case(cuda, F_ROUTED, E, 11)
    _, loop = _both(*args)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, tf32 = _both(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = [_close(t, r)[0] for t, r in zip(tf32, loop)]
    print("tf32", errs)
    assert any(e > TOL for e in errs), errs


def _layer(device):
    torch.manual_seed(0)
    return M.MoE(H, E, K, F_ROUTED, 2, 2.446, 1e-4, 1e-3, device=device)


def _layer_step(layer, x, mask):
    """One forward and backward of the layer: the output and the gradients."""
    x = x.detach().clone().requires_grad_(True)
    params = [p for p in layer.parameters() if p.requires_grad]
    y = layer(x, mask)
    loss = (y * y).mean() + layer.balance_loss
    return [y] + list(torch.autograd.grad(loss, [x] + params))


def test_one_captured_graph_replays_any_routing(cuda):
    layer = _layer(cuda)
    L, B = 112, 32
    mask = torch.zeros(L, B, dtype=torch.bool, device=cuda)
    mask[:100, :24] = True
    xs = [torch.randn(L, B, H, device=cuda, generator=torch.Generator(device=cuda).manual_seed(s))
          for s in (1, 2, 3)]
    static = xs[0].clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _layer_step(layer, static, mask)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = _layer_step(layer, static, mask)
    loads = []
    for x in xs[1:]:
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        loads.append(layer.last_load.clone())
        want = _layer_step(layer, x, mask)
        for got, ref in zip(outs, want):
            err, ok = _close(got, ref, 1e-6)
            assert ok, err
    assert not torch.equal(loads[0], loads[1])  # two routings
    assert int(loads[0].sum()) == 100 * 24 * K  # dropless: every routed row's K pairs


def test_an_eager_step_never_syncs(cuda):
    layer = _layer(cuda)
    x = torch.randn(112, 32, H, device=cuda)
    mask = torch.ones(112, 32, dtype=torch.bool, device=cuda)
    _layer_step(layer, x, mask)  # the libraries built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _layer_step(layer, x, mask)
        layer.update_bias()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_the_layer_matches_its_plain_loop(cuda, monkeypatch):
    """The layer with the kernels against the same layer on the plain loop."""
    layer = _layer(cuda)
    L, B = 112, 32
    mask = torch.zeros(L, B, dtype=torch.bool, device=cuda)
    mask[:110, :30] = True
    x = torch.randn(L, B, H, device=cuda)
    got = _layer_step(layer, x, mask)
    monkeypatch.setattr(M, "grouped_swiglu", O.grouped_swiglu_plain)
    want = _layer_step(layer, x, mask)
    errs = [_close(g, w)[0] for g, w in zip(got, want)]
    print("layer", errs)
    assert all(e <= TOL for e in errs), errs
    assert torch.isfinite(got[0]).all()  # the padded rows too
