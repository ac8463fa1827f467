"""The port's import of the reference's ``GAN_save/*.pth`` networks
(``utils/torch_import.py``, ``cli/import_reference.py``) against the JAX
package's importer, on the CPU.

The reference tree is not in the repo, so the test writes a stand-in one:
``tests/reference_gan_model.py`` copied to ``<tmp>/reference/model.py``,
whose six networks (2 encoder layers, ``D_h`` 100) are pickled whole, each
wrapped in ``nn.DataParallel`` as the reference saves them.  Both importers
then unpickle them with the stand-in tree on ``sys.path`` and must write
the same msgpack bytes; the port's files load strictly into the port's
networks and through the JAX package's reader, weights equal to the
stand-ins' in bits."""

import importlib.util
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch import nn

from gan_ffn_tpu.utils.checkpoint import load_params as jax_load_params
from gan_ffn_tpu.utils.torch_import import import_gan_save as jax_import_gan_save
from gan_ffn_tpu_torch.cli import import_reference as CLI
from gan_ffn_tpu_torch.train.gan import GANConfig, init_gan_state
from gan_ffn_tpu_torch.utils.checkpoint import GAN_NET_NAMES, load_gan_state
from gan_ffn_tpu_torch.utils.torch_import import reference_state_dict
from gan_ffn_tpu_torch.utils.weights import jax_params_from_state_dict

HERE = Path(__file__).resolve().parent
CLASSES = {"acoustic_gen": "AcousticGenerator", "visual_gen": "VisualGenerator",
           "text_gen": "TextGenerator", "acoustic_disc": "AcousticDiscriminator",
           "visual_disc": "VisualDiscriminator", "text_disc": "TextDiscriminator"}


@pytest.fixture(scope="module")
def gan_save(tmp_path_factory):
    """``(reference tree, GAN_save with the six .pth, the stand-in networks)``."""
    root = tmp_path_factory.mktemp("import")
    ref_dir, save = root / "reference", root / "GAN_save"
    ref_dir.mkdir()
    save.mkdir()
    shutil.copy(HERE / "reference_gan_model.py", ref_dir / "model.py")
    spec = importlib.util.spec_from_file_location("model", ref_dir / "model.py")
    model = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("model")
    sys.modules["model"] = model
    try:
        spec.loader.exec_module(model)
        torch.manual_seed(0)
        nets = {name: getattr(model, cls)(100, 0.2).eval() for name, cls in CLASSES.items()}
        for name, net in nets.items():
            torch.save(nn.DataParallel(net), save / f"{name}.pth")
    finally:  # the importers must find the module through the reference tree
        if saved is None:
            sys.modules.pop("model", None)
        else:
            sys.modules["model"] = saved
    return ref_dir, save, nets


@pytest.fixture
def clean_import_state(monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    saved = sys.modules.pop("model", None)
    yield
    sys.modules.pop("model", None)
    if saved is not None:
        sys.modules["model"] = saved


def test_cli_writes_the_jax_importers_bytes(gan_save, tmp_path, capsys, clean_import_state):
    ref_dir, save, nets = gan_save
    written = CLI.main(["--src", str(save), "--dst", str(tmp_path / "port"),
                        "--reference", str(ref_dir)])
    assert set(written) == set(CLASSES)
    out = capsys.readouterr().out
    assert all(f"{name} -> " in out for name in CLASSES)
    sys.modules.pop("model", None)
    jax_written = jax_import_gan_save(str(save), str(tmp_path / "jax"), reference_path=str(ref_dir))
    assert set(jax_written) == set(CLASSES)
    for name in CLASSES:
        assert Path(written[name]).read_bytes() == Path(jax_written[name]).read_bytes(), name


def test_imported_networks_load_into_both_packages(gan_save, tmp_path, clean_import_state):
    """The port's --use-trained-GAN reader (load_gan_state, strict, at the
    stand-ins' depth) and the JAX package's reader give the stand-ins'
    weights in bits; the positional buffer is not among them."""
    ref_dir, save, nets = gan_save
    dst = tmp_path / "GAN_save"
    CLI.main(["--src", str(save), "--dst", str(dst), "--reference", str(ref_dir)])
    state = init_gan_state(GANConfig(num_layers=2), device="cpu")
    load_gan_state(str(dst), state.modules, state.opts, reset_opt=True)
    for name in GAN_NET_NAMES:
        want = reference_state_dict(nets[name])
        got = state.modules[name].state_dict()
        assert set(got) == set(want) and not any(k.endswith("pe") for k in got)
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)
        assert torch.equal(got["net.fc1.weight"], nets[name].fc1.weight.detach())
        want_tree = jax_params_from_state_dict(state.modules[name])
        zeros = jax.tree.map(np.zeros_like, want_tree)  # the JAX reader's template
        got_tree = jax_load_params(str(dst / f"{name}.msgpack"), zeros)
        for got_leaf, want_leaf in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
            np.testing.assert_array_equal(np.asarray(got_leaf), want_leaf)
        assert len(jax.tree.leaves(got_tree)) == len(want) == 12 * 2 + 2 * (2 if "gen" in name else 3) + (2 if name == "visual_disc" else 0)


def test_missing_files_are_skipped(tmp_path, capsys):
    assert CLI.main(["--src", str(tmp_path), "--dst", str(tmp_path / "out")]) == {}
    assert "no .pth checkpoints found" in capsys.readouterr().out
