"""The benchmark's frozen Philox copy draws the port's masks bit for bit."""

import pytest
import torch

from gan_ffn_tpu_torch.ops import dropout as port
from portbench.lib import philox

from . import tiny  # noqa: F401  (puts the checkout on the path)


@pytest.mark.parametrize("base", [0, 1, 2**31 + 7, 2**62 + 12345, 2**63 - 2])
def test_derive_seed_matches(base):
    for k in (0, 1, 5, 31, 1000):
        assert philox.derive_seed(base, k) == port.derive_seed(base, k)


@pytest.mark.parametrize("stream", [port.STREAM_ATTENTION, port.STREAM_PRE, port.STREAM_MID,
                                    port.STREAM_POST])
@pytest.mark.parametrize("rate", [0.1, 0.2])
def test_keep_scale_matches(stream, rate):
    seed = port.derive_seed(987654321987, 3)
    shape = (7, 3, 13, 11)
    assert torch.equal(philox.keep_scale(seed, stream, shape, rate),
                       port.keep_scale(seed, stream, shape, rate))


def test_step_stream_numbers_calls_as_the_port():
    base = 2**40 + 99
    stream = philox.StepStream(base)
    seeds = port.StepSeeds()
    with seeds.step(torch.tensor(base)):
        for _ in range(4):
            assert stream.next() == int(port.resolve_seed(seeds.next()))
