"""The port's CUDA runtime module (``gan_ffn_tpu_torch/utils/runtime.py``),
mirroring the JAX package's tests of ``wait_for_device``
(tests/test_utils.py) with tiny delays: the watchdog's two diagnostics, the
retries, the refusals; and ``configure_cuda_runtime``: the float32 flags,
the kernel build directory, and that it is the one place the port sets
those flags.  No card is needed: the card's probe is replaced."""

import re
import time
from pathlib import Path

import pytest
import torch

from gan_ffn_tpu_torch.cli import common as COMMON
from gan_ffn_tpu_torch.cli import train_iemocap as FLAGSHIP
from gan_ffn_tpu_torch.ops import _build
from gan_ffn_tpu_torch.utils import runtime

REPO = Path(__file__).resolve().parents[1]
FLAGS = (
    (torch.backends.cuda.matmul, "allow_tf32"),
    (torch.backends.cudnn, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"),
)


def test_wait_for_device_watchdog_reports_hang(monkeypatch, capsys):
    """A blocking initialisation leaves periodic stderr diagnostics, and the
    device comes through once it returns."""
    sentinel = torch.device("cuda", 0)

    def slow(device):
        time.sleep(0.35)
        return sentinel

    monkeypatch.setattr(runtime, "_probe", slow)
    assert runtime.wait_for_device("cuda:0", attempts=1, delay_s=0.0, hang_warn_s=0.1) is sentinel
    err = capsys.readouterr().err
    assert "device init still pending" in err
    assert "initialisation is blocking" in err  # the blocked-in-call diagnostic


def test_wait_for_device_watchdog_distinguishes_raising_retries(monkeypatch, capsys):
    """An initialisation that raises is retried ``attempts`` times, the
    watchdog says the retries fire, and the last error is raised: no
    device, and never the CPU."""
    calls = []

    def raising(device):
        calls.append(device)
        raise RuntimeError("CUDA not ready yet")

    monkeypatch.setattr(runtime, "_probe", raising)
    with pytest.raises(RuntimeError, match="not ready"):
        runtime.wait_for_device("cuda", attempts=3, delay_s=0.15, hang_warn_s=0.1)
    assert calls == [torch.device("cuda")] * 3
    err = capsys.readouterr().err
    assert "retrying after the backoff sleep" in err
    assert "initialisation is blocking" not in err


def test_wait_for_device_refuses_bad_arguments():
    with pytest.raises(ValueError, match="attempts"):
        runtime.wait_for_device(attempts=0)
    with pytest.raises(ValueError, match="CUDA card"):
        runtime.wait_for_device("cpu")


def test_wait_for_device_no_watchdog_noise_when_fast(monkeypatch, capsys):
    monkeypatch.setattr(runtime, "_probe", lambda device: device)
    assert runtime.wait_for_device(hang_warn_s=5.0) == torch.device("cuda")
    assert "device init still pending" not in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the refusal on a box without a card")
def test_wait_for_device_raises_without_a_card():
    with pytest.raises((RuntimeError, AssertionError)):
        runtime.wait_for_device(attempts=1, delay_s=0.0, hang_warn_s=0.0)


@pytest.fixture
def saved_runtime(monkeypatch):
    """Restore the flags and the build directory after the test."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in FLAGS]
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("GANFFN_KERNEL_BUILD_DIR", raising=False)
    yield
    for owner, name, value in saved:
        setattr(owner, name, value)


def test_configure_cuda_runtime_pins_float32(saved_runtime):
    for owner, name in FLAGS:
        setattr(owner, name, True)
    default = _build.BUILD_DIR
    runtime.configure_cuda_runtime()
    assert all(getattr(owner, name) is False for owner, name in FLAGS)
    assert _build.BUILD_DIR == default == REPO / "build" / "kernels"


def test_configure_cuda_runtime_moves_the_kernel_builds(saved_runtime, monkeypatch, tmp_path):
    """The JAX compile cache's counterpart: an argument, else the
    environment variable."""
    runtime.configure_cuda_runtime(tmp_path / "a")
    assert _build.BUILD_DIR == tmp_path / "a"
    monkeypatch.setenv("GANFFN_KERNEL_BUILD_DIR", str(tmp_path / "b"))
    runtime.configure_cuda_runtime()
    assert _build.BUILD_DIR == tmp_path / "b"


def test_only_the_runtime_module_sets_the_float32_flags():
    """No other file of the port, nor chip_smoke.py, assigns them."""
    pattern = re.compile(r"(allow_tf32|allow_bf16_reduced_precision_reduction|"
                         r"allow_fp16_reduced_precision_reduction)\s*=(?!=)|"
                         r"set_float32_matmul_precision")
    files = sorted((REPO / "gan_ffn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    setters = [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
    assert setters == ["gan_ffn_tpu_torch/utils/runtime.py"]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_trainers_configure_the_runtime_and_wait_for_a_card(device, monkeypatch):
    """``cli/common.setup`` (every trainer's start) configures the runtime
    and waits for the card where one is asked for; on the CPU it waits for
    nothing."""
    calls = []
    monkeypatch.setattr(COMMON, "configure_cuda_runtime", lambda: calls.append("configure"))
    monkeypatch.setattr(COMMON, "wait_for_device", lambda d: calls.append(("wait", d)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a stand-in card")
    _, got = COMMON.setup(FLAGSHIP.build_parser(), ["--device", device], write_fixture=None)
    assert got == torch.device(device)
    assert calls == (["configure"] if device == "cpu"
                     else ["configure", ("wait", torch.device("cuda"))])
