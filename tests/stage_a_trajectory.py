"""Stage A's 15-epoch loss trajectory at depth 1, on the CPU, for the JAX
package and the port, from either framework's initial weights.

    JAX_PLATFORMS=cpu python tests/stage_a_trajectory.py [--seeds 3407 1 2]

On the fixture of ``tests/conftest.py::iemocap_pickle``, it prints one JSON
line for each run: the JAX package from its own init at each seed, the port
from its own init at each seed, and the port from the JAX init at each seed
(carried across by ``utils.weights.gan_state_dicts_from_jax``).  Each line
holds the six logged losses at epochs 5, 10 and 15, the epochs that
``tests/test_train.py::test_stage_a_loss_trajectory_band`` pins.  The two
frameworks draw their dropout masks from different streams, so equal
trajectories are not expected: this shows how far the init and the streams
each move them.
"""

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gan_ffn_tpu.cli.common import train_gan as jax_train_gan  # noqa: E402
from gan_ffn_tpu.data import get_iemocap_loaders as jax_loaders  # noqa: E402
from gan_ffn_tpu.train import gan as JG  # noqa: E402
from gan_ffn_tpu_torch.cli.common import train_gan  # noqa: E402
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap  # noqa: E402
from gan_ffn_tpu_torch.train import gan as TG  # noqa: E402
from gan_ffn_tpu_torch.utils.weights import gan_state_dicts_from_jax  # noqa: E402

EPOCHS = (5, 10, 15)


def jax_init(seed: int):
    cfg = JG.GANConfig(num_layers=1, aot_cache=False, seed=seed)
    return jax.tree.map(np.asarray, JG.init_gan_state(cfg, jax.random.PRNGKey(seed))["params"])


def port_history(path: str, seed: int, from_jax: bool):
    cfg = TG.GANConfig(num_layers=1, seed=seed)
    state = TG.init_gan_state(cfg, device="cpu")
    if from_jax:
        for name, sd in gan_state_dicts_from_jax(jax_init(seed)).items():
            state.modules[name].load_state_dict(sd, strict=True)
    loader, _, _ = get_iemocap_loaders(path, batch_size=32, valid=0.1)
    torch.manual_seed(seed + 1)
    return train_gan(cfg, loader, max(EPOCHS), state=state, device="cpu",
                     log=lambda s: None, log_every_batch=False)[1]


def jax_history(path: str, seed: int):
    loader, _, _ = jax_loaders(path, batch_size=32, valid=0.1)
    cfg = JG.GANConfig(num_layers=1, aot_cache=False, seed=seed)
    return jax_train_gan(cfg, loader, max(EPOCHS), log=lambda s: None, log_every_batch=False)[1]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[3407, 1, 2])
    args = p.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_synthetic_iemocap(os.path.join(tmp, "IEMOCAP_features.pkl"), n_train=24,
                                       n_test=8, min_len=4, max_len=40)
        runs = [("jax", s, lambda s=s: jax_history(path, s)) for s in args.seeds]
        runs += [("port", s, lambda s=s: port_history(path, s, False)) for s in args.seeds]
        runs += [("port_from_jax_init", s, lambda s=s: port_history(path, s, True))
                 for s in args.seeds]
        for name, seed, run in runs:
            history = run()
            print(json.dumps({"run": name, "seed": seed,
                              "losses": {e: history[e - 1] for e in EPOCHS}}), flush=True)


if __name__ == "__main__":
    main()
