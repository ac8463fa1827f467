"""The port's public surface: every name that an ``__all__`` of the JAX
package's subpackages lists has a counterpart of the same name in the
port's subpackage of the same name, but for the exclusions below, each with
its reason.  The JAX ``__all__`` is read from the source, so no JAX module
is imported here."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("nn", "models", "data", "train", "utils", "ops", "parallel", "evaluation")
EXCLUDED = {
    ("ops", "use_pallas_attention"): "the TPU's kernel switch (ops/config.py); the port "
                                     "dispatches by the tensors' device, by design",
    ("ops", "pallas_attention_enabled"): "the same switch's query",
    ("parallel", "make_mesh"): "a JAX device mesh; the port's group is "
                               "parallel.init_data_parallel",
    ("nn", "TorchLinear"): "flax's torch-initialised Dense; the port's is nn.core.Linear",
    ("nn", "torch_linear_kernel_init"): "TorchLinear's init; nn.core.Linear draws its own",
    ("nn", "torch_linear_bias_init"): "TorchLinear's init; nn.core.Linear draws its own",
    ("utils", "configure_tpu_runtime"): "the TPU's settings; the port's are "
                                        "utils.runtime.configure_cuda_runtime",
    ("train", "ClassifierState"): "the JAX {params, opt} pytree; the port's state is the "
                                  "module and its torch.optim.Adam",
    ("train", "init_classifier_state"): "builds that pytree; the port builds "
                                        "train.optim.torch_adam over the module",
}


def jax_all(subpackage: str):
    tree = ast.parse((REPO / "gan_ffn_tpu" / subpackage / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return [e.value for e in node.value.elts]
    return []


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_port_exports_the_jax_surface(subpackage):
    names = jax_all(subpackage)
    assert names, f"gan_ffn_tpu/{subpackage} lists no __all__"
    port = importlib.import_module(f"gan_ffn_tpu_torch.{subpackage}")
    missing = [n for n in names if (subpackage, n) not in EXCLUDED and not hasattr(port, n)]
    assert missing == []
    exported = set(getattr(port, "__all__", ()))
    assert exported <= set(dir(port))
    assert [n for n in names if hasattr(port, n) and n not in exported] == []


def test_exclusions_name_real_jax_exports():
    """Every exclusion is a name the JAX package exports and the port does
    not: a stale entry fails here."""
    for (subpackage, name), reason in EXCLUDED.items():
        assert reason
        if name == "configure_tpu_runtime":  # exported by utils/runtime.py, not utils/__init__
            assert "def configure_tpu_runtime" in (
                REPO / "gan_ffn_tpu" / "utils" / "runtime.py").read_text()
        else:
            assert name in jax_all(subpackage), (subpackage, name)
        port = importlib.import_module(f"gan_ffn_tpu_torch.{subpackage}")
        assert not hasattr(port, name), (subpackage, name)


def test_runtime_module_counterparts():
    """utils/runtime.py has no __all__ in either package: its functions."""
    from gan_ffn_tpu_torch.utils import runtime

    assert callable(runtime.configure_cuda_runtime) and callable(runtime.wait_for_device)
