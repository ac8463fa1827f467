"""Data parallelism of the port (``gan_ffn_tpu_torch/parallel``), held to the
port's single process and to the JAX package's mesh DP.

Two ranks run as spawned gloo processes (``tests/torch_dp_ranks.py``), one
intra-op thread each, with a timeout on the rendezvous and on the join; the
JAX references (``make_gan_train_step(cfg, mesh=...)`` and the classifier
step on a 2-device mesh) are computed here, in the parent, while they run.
Every step is deterministic (rate 0) at depth 1, L = 8, B = 4, but for the
epoch-fused stage A's run with every dropout on (held between its ranks
and to the per-batch loop, in bits).  Tolerances:
against the port's single process, losses 1e-6 relative and parameters 1e-6
of max(1, max |ref|); against JAX those of tests/test_torch_gan.py (losses
1e-5 relative, parameters 1e-6) and tests/test_torch_train.py.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS, make_gan_ffn_apply_fns
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.parallel import batch_sharding as jax_batch_sharding
from gan_ffn_tpu.parallel import make_mesh, replicate as jax_replicate
from gan_ffn_tpu.parallel import shard_batch as jax_shard_batch
from gan_ffn_tpu.train import gan as JG
from gan_ffn_tpu.train.classifier import init_classifier_state
from gan_ffn_tpu.train.classifier import make_classifier_steps as jax_steps
from gan_ffn_tpu.train.optim import torch_adam as jax_adam
from gan_ffn_tpu_torch.cli import common as COMMON
from gan_ffn_tpu_torch.cli import train_iemocap as FLAGSHIP
from gan_ffn_tpu_torch.cli import train_iemocap_dialoguernn as DRNN
from gan_ffn_tpu_torch.data import write_synthetic_iemocap
from gan_ffn_tpu_torch.models import GAN_FFN
from gan_ffn_tpu_torch.nn.losses import bce_denominator, bce_loss, masked_nll_loss, nll_denominator
from gan_ffn_tpu_torch.ops.dropout import STREAM_ATTENTION, StepSeeds, draw_seed, fold_rank, keep_scale
from gan_ffn_tpu_torch.parallel import batch_sharding, init_data_parallel, shard_batch
from gan_ffn_tpu_torch.train import gan as TG
from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax, gan_state_dicts_from_jax

REPO = Path(__file__).resolve().parents[1]
L, B, DIMS = 8, 4, {"audio": 100, "visual": 512, "text": 100}
GAN_VALID_LEN, GAN_N_REAL = 6, 3  # rank 1 holds one real dialogue and padded steps
CLF_N_REAL = 2  # rank 1's shard is all padding
EPS = 1e-3  # Adam eps in both frameworks, as tests/test_torch_gan.py (EPS) explains
SWEEP_SEEDS = [3, 4, 5]
RANK_TIMEOUT = 240  # seconds for both ranks to finish
TOL = 1e-6


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_batches():
    rng = np.random.default_rng(0)
    feats = {k: rng.standard_normal((L, B, d)).astype(np.float32) for k, d in DIMS.items()}
    lengths = np.array([8, 5, 0, 0])
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    clf = {**{k: v * umask.T[:, :, None] for k, v in feats.items()}, "umask": umask,
           "label": (rng.integers(0, 6, (B, L)) * umask).astype(np.int64),
           "qmask": np.zeros((L, B, 2), np.float32)}
    return feats, clf


def _port_batch(host, valid_len, n_real):
    return {**{k: torch.from_numpy(v) for k, v in host.items()},
            "valid_len": torch.tensor(valid_len, dtype=torch.int32),
            "n_real": torch.tensor(n_real, dtype=torch.int32)}


def _jax_batch(host, valid_len, n_real):
    return {**{k: jnp.asarray(v) for k, v in host.items()},
            "valid_len": jnp.asarray(valid_len, jnp.int32), "n_real": jnp.asarray(n_real, jnp.int32)}


class _EvalMode:
    """A JAX module whose ``apply`` always runs deterministic (rate 0)."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self.module.apply(variables, *args, deterministic=True, **kw)


def _jax_mesh_gan_step(cfg, mesh):
    """JAX ``make_gan_train_step(cfg, mesh)`` with its six networks in eval
    mode and Adam eps EPS (both patched in the test, not in the package)."""
    create = JG.create_gan_modules
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "create_gan_modules",
                   lambda c: {k: _EvalMode(m) for k, m in create(c).items()})
        mp.setattr(JG, "torch_adam", functools.partial(jax_adam, eps=EPS))
        return JG.make_gan_train_step(cfg, mesh=mesh)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, cpu_devices):
    """Spawn the two gloo ranks; meanwhile compute the single-process and
    JAX references here."""
    out = tmp_path_factory.mktemp("dp")
    feats, clf_host = _host_batches()
    cfg = JG.GANConfig(num_layers=1, fused_schedule=False, aot_cache=False, dropout=0.0)
    jstate = JG.init_gan_state(cfg, jax.random.PRNGKey(5))
    gan_params = jax.tree.map(np.asarray, jstate["params"])
    jm = JaxGAN_FFN(n_classes=6, gen_num_layers=1)
    clf_params = jm.init(jax.random.PRNGKey(0), jnp.asarray(clf_host["audio"]),
                         jnp.asarray(clf_host["visual"]), jnp.asarray(clf_host["text"]))["params"]
    clf_params = jax.tree.map(np.asarray, clf_params)
    inputs = {"gan": gan_state_dicts_from_jax(gan_params), "clf": gan_ffn_state_dict_from_jax(clf_params),
              "gan_batch": _port_batch(feats, GAN_VALID_LEN, GAN_N_REAL),
              "clf_batch": _port_batch(clf_host, L, CLF_N_REAL),
              "weights": torch.from_numpy(IEMOCAP_LOSS_WEIGHTS), "eps": EPS,
              "sweep_seeds": SWEEP_SEEDS}
    inputs["fixture"] = write_synthetic_iemocap(str(out / "fused.pkl"), n_train=8, n_test=2,
                                                min_len=4, max_len=12, seed=1)
    torch.save(inputs, out / "inputs.pt")
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dp_ranks.py"), str(out)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    # the trainer under torch.distributed.run on two CPU ranks, meanwhile
    cli_dir = tmp_path_factory.mktemp("cli")
    data = write_synthetic_iemocap(str(cli_dir / "iemocap.pkl"), n_train=16, n_test=6,
                                   min_len=4, max_len=12, seed=0)
    cli_env = {k: v for k, v in env.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "gan_ffn_tpu_torch.cli.train_iemocap", "--dp", "--GAN-epochs", "1", "--epochs", "1",
         "--num-layers", "1", "--device", "cpu", "--data-path", data],
        cwd=cli_dir, env=cli_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        refs = {"inputs": inputs}
        # the port's single process, one thread as the ranks run
        with one_thread():
            refs["gan"] = _port_gan_step(inputs)
            refs["clf"] = _port_clf_step(inputs)
            refs["fused"] = _port_fused_epoch(inputs)
            refs["fold_mask"] = keep_scale(StepSeeds(torch.Generator().manual_seed(7)).draw(),
                                           STREAM_ATTENTION, (4, 64), 0.5)
            refs["sweep"] = {}
            for s in SWEEP_SEEDS:
                model = GAN_FFN(n_classes=6, gen_num_layers=1,
                                generator=torch.Generator().manual_seed(s), device="cpu")
                step, _ = make_classifier_steps(model, torch_adam(model.parameters(), 1e-3, eps=EPS),
                                                6, deterministic=True)
                refs["sweep"][s] = (step(inputs["clf_batch"])[0].item(), model.state_dict())
        # JAX's mesh DP on two CPU devices
        mesh = make_mesh(cpu_devices[:2])
        jstate = jax_replicate(jstate, mesh)
        jstate, jlosses = _jax_mesh_gan_step(cfg, mesh)(
            jstate, jax_shard_batch(_jax_batch(feats, GAN_VALID_LEN, GAN_N_REAL), mesh),
            jax.random.PRNGKey(1))
        refs["jax_gan"] = ([float(jlosses[f"duel_{i}"]) for i in range(12)],
                           gan_state_dicts_from_jax(jax.tree.map(np.asarray, jstate["params"])))
        _, apply_eval = make_gan_ffn_apply_fns(jm)
        opt = jax_adam(1e-3, eps=EPS, weight_decay=0.008)
        jtrain, _ = jax_steps(lambda p, rng, b: apply_eval(p, b), apply_eval, opt, 6,
                              jnp.asarray(IEMOCAP_LOSS_WEIGHTS))
        cstate = init_classifier_state(jax_replicate(jax.tree.map(jnp.asarray, clf_params), mesh), opt)
        cstate = {"params": cstate["params"], "opt": jax_replicate(cstate["opt"], mesh)}
        cstate, closs, _ = jtrain(cstate, jax.random.PRNGKey(7),
                                  jax_shard_batch(_jax_batch(clf_host, L, CLF_N_REAL), mesh))
        refs["jax_clf"] = (float(closs), gan_ffn_state_dict_from_jax(
            jax.tree.map(np.asarray, cstate["params"])))
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs[:2]] == [0, 0], "\n".join(logs[:2])
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return refs, ranks, (procs[2].returncode, logs[2], cli_dir)


def _port_gan_step(inputs):
    state = TG.init_gan_state(TG.GANConfig(num_layers=1), device="cpu")
    for name, sd in inputs["gan"].items():
        state.modules[name].load_state_dict(sd, strict=True)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = EPS
    losses = TG.make_gan_train_step(state.modules, state.opts, deterministic=True)(inputs["gan_batch"])
    return ([losses[f"duel_{i}"].item() for i in range(12)],
            {n: m.state_dict() for n, m in state.modules.items()})


def _port_fused_epoch(inputs):
    """One process's deterministic stage-A epoch over the ranks' loader."""
    from gan_ffn_tpu_torch.data import get_iemocap_loaders

    state = TG.init_gan_state(TG.GANConfig(num_layers=1), device="cpu")
    for name, sd in inputs["gan"].items():
        state.modules[name].load_state_dict(sd, strict=True)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = EPS
    loader = get_iemocap_loaders(inputs["fixture"], batch_size=4, valid=0.0, seed=0)[0]
    step = TG.make_gan_train_step(state.modules, state.opts, deterministic=True)
    _, history = COMMON.train_gan(TG.GANConfig(num_layers=1, seed=0), loader, 1, state=state,
                                  device="cpu", log=lambda line: None, step=step)
    return history, {n: m.state_dict() for n, m in state.modules.items()}


def _port_clf_step(inputs):
    model = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu")
    model.load_state_dict(inputs["clf"])
    opt = torch_adam(model.parameters(), 1e-3, eps=EPS, weight_decay=0.008)
    step, _ = make_classifier_steps(model, opt, 6, inputs["weights"], deterministic=True)
    loss, preds = step(inputs["clf_batch"])
    return loss.item(), preds, model.state_dict()


def _close(got: dict, want: dict, atol=None, rel=TOL, what=""):
    assert set(got) == set(want), what
    for k, w in want.items():
        w = torch.as_tensor(w)
        limit = atol if atol is not None else rel * max(1.0, w.abs().max().item())
        err = (got[k] - w).abs().max().item()
        assert err <= limit, f"{what} {k}: {err} > {limit}"


# ---- shard_batch, losses and the rank fold (no spawn) ----

ROLES = ("text", "visual", "audio", "qmask", "umask", "label", "valid_len", "n_real")


@pytest.mark.parametrize("name", ROLES)
def test_shard_batch_matches_jax_shards(name, cpu_devices):
    """Each role's axis (JAX's PartitionSpec) and each rank's slice equal the
    JAX mesh's shard on device r; ``n_real`` is the rank's own count."""
    _, host = _host_batches()
    spec = tuple(jax_batch_sharding(make_mesh(cpu_devices[:2]), name).spec)
    assert batch_sharding(name) == ({(None, "data"): 1, ("data",): 0}.get(spec))
    whole = {**host, "valid_len": np.asarray(L, np.int32), "n_real": np.asarray(3, np.int32)}
    sharded = jax_shard_batch({k: jnp.asarray(v) for k, v in whole.items()},
                              make_mesh(cpu_devices[:2]))[name]
    shards = sorted(sharded.addressable_shards, key=lambda s: s.device.id)
    port = {k: torch.from_numpy(np.asarray(v)) for k, v in whole.items()}
    for r in range(2):
        got = shard_batch(port, r, 2)[name].numpy()
        if name == "n_real":
            assert np.asarray(shards[r].data) == 3 and int(got) == [2, 1][r]
        else:
            np.testing.assert_array_equal(got, np.asarray(shards[r].data))


def test_shard_batch_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"text": torch.zeros(L, 3, 100)}, 0, 2)
    assert shard_batch({"text": torch.zeros(L, 4, 1), "host_n_real": 3}, 1, 2)["host_n_real"] == 1


def test_global_denominators_sum_to_the_whole_and_survive_a_padding_shard():
    """Each half's numerator over the whole batch's denominator: the halves
    sum to the whole batch's loss, and an all-padding half gives 0."""
    rng = np.random.default_rng(1)
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)), 1)
    target = torch.from_numpy(rng.integers(0, 6, 8))
    mask = torch.tensor([1, 1, 0, 1, 0, 0, 0, 0], dtype=torch.float32)
    weight = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS)
    whole = masked_nll_loss(lp, target, mask, weight)
    den = nll_denominator(target, mask, weight)
    halves = [masked_nll_loss(lp[s], target[s], mask[s], weight, den)
              for s in (slice(0, 4), slice(4, 8))]
    assert halves[1].item() == 0.0
    assert torch.isnan(masked_nll_loss(lp[4:], target[4:], mask[4:], weight))  # a local mean: 0 / 0
    np.testing.assert_allclose(sum(h.item() for h in halves), whole.item(), rtol=1e-6)
    pred = torch.sigmoid(torch.from_numpy(rng.standard_normal((3, 4, 1)).astype(np.float32)))
    m = torch.tensor([[1, 1, 0, 0]] * 2 + [[0, 0, 0, 0]], dtype=torch.float32)[:, :, None]
    den = bce_denominator(m, pred.shape, pred.dtype)
    parts = [bce_loss(pred[:, s], torch.ones(3, 2, 1), m[:, s], den) for s in (slice(0, 2), slice(2, 4))]
    assert parts[1].item() == 0.0
    np.testing.assert_allclose(sum(p.item() for p in parts), bce_loss(pred, torch.ones_like(pred), m).item(),
                               rtol=1e-6)


def test_fold_rank_keeps_rank_zero_and_moves_the_others():
    gen = torch.Generator().manual_seed(3)
    base = draw_seed(torch.Generator().manual_seed(3))
    assert StepSeeds(gen, rank=0).draw() == base == fold_rank(base, 0)
    folded = {fold_rank(base, r) for r in range(1, 5)}
    assert len(folded) == 4 and base not in folded and all(0 <= f < 2**63 for f in folded)


def test_init_data_parallel_without_torchrun_is_one_process(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    dp = init_data_parallel("cpu")
    assert (dp.rank, dp.world, dp.group) == (0, 1, None)


# ---- two gloo ranks ----

def test_ranks_joined_one_gloo_group(dp_run):
    _, ranks, _ = dp_run
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [(0, 2, "gloo"), (1, 2, "gloo")]


def test_dp_stage_a_step_matches_one_process(dp_run):
    """Rank 1 starts from perturbed weights that ``replicate`` overwrites;
    both ranks end with the same bits, within 1e-6 of one process."""
    refs, ranks, _ = dp_run
    want_losses, want_state = refs["gan"]
    for r in ranks:
        np.testing.assert_allclose(r["gan"]["losses"], want_losses, rtol=TOL)
        for name, sd in want_state.items():
            _close(r["gan"]["state"][name], sd, what=name)
    for name, sd in ranks[0]["gan"]["state"].items():
        assert all(torch.equal(v, ranks[1]["gan"]["state"][name][k]) for k, v in sd.items()), name


def test_dp_epoch_fused_stage_a_matches_the_per_batch_loop_and_one_process(dp_run):
    """``train_gan(dp=, epoch_fused=True)`` for one epoch on a one-bucket
    loader (two batches of 4): deterministic, equal to the per-batch DP loop
    in bits on both ranks and to one process within 1e-6 (loss rows
    relative, parameters of max(1, max |ref|)); with every dropout on (the
    trainers' step), equal to the per-batch DP loop in bits; in each run both
    ranks end with equal parameters after all-reducing the gradients (twelve
    all-reduces and one loss sum per batch); the trainers' step builder hands
    the rank to the epoch step's seed source."""
    refs, ranks, _ = dp_run
    history, want = refs["fused"]
    for rank in ranks:
        runs = rank["fused"]
        assert runs["step_rank"] == rank["rank"]
        for deterministic in (True, False):
            fused, per_batch = runs[(True, deterministic)], runs[(False, deterministic)]
            assert fused["history"] == per_batch["history"]
            for name, sd in per_batch["state"].items():
                for k, v in sd.items():
                    assert torch.equal(fused["state"][name][k], v), (deterministic, name, k)
            assert fused["all_reduces"] == per_batch["all_reduces"] == 2 * 13
        got = runs[(True, True)]
        for row, ref in zip(got["history"], history):
            for k, v in ref.items():
                assert abs(row[k] - v) <= TOL * max(1.0, abs(v)), (k, row[k], v)
        for name, sd in want.items():
            _close(got["state"][name], sd, what=f"rank {rank['rank']} {name}")
    for deterministic in (True, False):
        for name, sd in ranks[0]["fused"][(True, deterministic)]["state"].items():
            other = ranks[1]["fused"][(True, deterministic)]["state"][name]
            assert all(torch.equal(other[k], v) for k, v in sd.items()), (deterministic, name)


def test_dp_stage_a_step_matches_jax_mesh(dp_run):
    refs, ranks, _ = dp_run
    want_losses, want_state = refs["jax_gan"]
    np.testing.assert_allclose(ranks[0]["gan"]["losses"], want_losses, rtol=1e-5)
    for name, sd in want_state.items():
        _close(ranks[0]["gan"]["state"][name], sd, atol=1e-6, what=name)


def test_dp_classifier_step_matches_one_process_on_a_padding_shard(dp_run):
    refs, ranks, _ = dp_run
    want_loss, want_preds, want_state = refs["clf"]
    for r in ranks:
        assert np.isfinite(r["clf"]["loss"])
        assert all(torch.isfinite(v).all() for v in r["clf"]["state"].values())
        np.testing.assert_allclose(r["clf"]["loss"], want_loss, rtol=TOL)
        assert torch.equal(r["clf"]["preds"], want_preds)
        _close(r["clf"]["state"], want_state)


def test_dp_classifier_step_matches_jax_mesh(dp_run):
    refs, ranks, _ = dp_run
    want_loss, want_state = refs["jax_clf"]
    np.testing.assert_allclose(ranks[0]["clf"]["loss"], want_loss, rtol=1e-5)
    _close(ranks[0]["clf"]["state"], want_state, atol=1e-6)


@pytest.mark.parametrize("step", ["gan", "clf"])
def test_a_group_of_one_is_no_group_in_bits(dp_run, step):
    """Every dropout on: a one-process group's step and no group's."""
    _, ranks, _ = dp_run
    grouped, alone = ranks[0]["world_one"][step]
    if step == "gan":
        assert grouped["losses"] == alone["losses"]
        pairs = [(grouped["state"][n], alone["state"][n]) for n in alone["state"]]
    else:
        assert grouped["loss"] == alone["loss"] and torch.equal(grouped["preds"], alone["preds"])
        pairs = [(grouped["state"], alone["state"])]
    for got, want in pairs:
        assert all(torch.equal(got[k], v) for k, v in want.items())


def test_rank_folded_dropout(dp_run):
    """Rank 0 draws the single-process base and masks; rank 1 others; a
    step built with a group sets its seed source's rank."""
    refs, ranks, _ = dp_run
    assert torch.equal(ranks[0]["fold"]["mask"], refs["fold_mask"])
    assert ranks[1]["fold"]["base"] != ranks[0]["fold"]["base"]
    assert not torch.equal(ranks[1]["fold"]["mask"], refs["fold_mask"])
    assert [(r["fold"]["step_rank"], r["fold"]["clf_step_rank"]) for r in ranks] == [(0, 0), (1, 1)]


@pytest.mark.parametrize("grid", ["1x2", "2x1"])
def test_seed_split_and_grids(dp_run, grid):
    """1 x 2: both ranks train every seed data-parallel (1e-6 of one
    process); 2 x 1: rank r trains seeds[r::2] alone (its bits).  Every
    rank gathers every seed."""
    refs, ranks, _ = dp_run
    got = [r["grids"][grid] for r in ranks]
    if grid == "1x2":
        assert [(g["row"], g["column"], g["data_world"]) for g in got] == [(0, 0, 2), (0, 1, 2)]
        assert [g["local_seeds"] for g in got] == [SWEEP_SEEDS, SWEEP_SEEDS]
    else:
        assert [(g["row"], g["column"], g["data_world"]) for g in got] == [(0, 0, 1), (1, 0, 1)]
        assert [g["local_seeds"] for g in got] == [SWEEP_SEEDS[0::2], SWEEP_SEEDS[1::2]]
    for g in got:
        assert sorted(g["results"]) == SWEEP_SEEDS
        for s, (loss, state) in g["results"].items():
            want_loss, want_state = refs["sweep"][s]
            if grid == "2x1":
                assert loss == want_loss
                assert all(torch.equal(state[k], v) for k, v in want_state.items())
            else:
                np.testing.assert_allclose(loss, want_loss, rtol=TOL)
                _close(state, want_state)
    assert refs["sweep"][3][0] != refs["sweep"][4][0]


# ---- the trainers' --dp ----

def test_cli_dp_on_two_gloo_ranks(dp_run):
    """``torch.distributed.run`` with two CPU ranks: stage A data-parallel,
    then rank 0 alone runs stage B and writes every file."""
    rc, log, cwd = dp_run[2]
    assert rc == 0, log[-6000:]
    for r in range(2):
        assert f"stage A data parallelism over 2 process(es): rank {r} on cpu, backend gloo" in log
    assert "rank 1: stage A done; rank 0 runs stage B" in log
    with open(cwd / "output" / "GAN_loss.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and all(np.isfinite(float(v)) for v in rows[0].values())
    for name in TG.GEN_NAMES + TG.DISC_NAMES:
        assert (cwd / "GAN_save" / f"{name}.msgpack").is_file()
    assert (cwd / "GAN_save" / "classifier_best.msgpack").is_file()
    assert len(list((cwd / "output").glob("test_out_GAN-epochs=1_F1-score=*.txt"))) == 1
    assert [l.startswith("epoch 1 ") for l in log.splitlines()].count(True) == 1


@pytest.mark.parametrize("cli", [FLAGSHIP, DRNN], ids=["flagship", "dialoguernn"])
def test_cli_dp_without_a_group_runs_one_process(cli, monkeypatch, capsys):
    """No torchrun environment: the JAX trainer's message, and no group, so
    the trainer runs its single-process stage A."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    args = cli.build_parser().parse_args(["--dp", "--device", "cpu"])
    dp, device = COMMON.data_parallel(args, torch.device("cpu"))
    assert (dp, device) == (None, torch.device("cpu"))
    assert "--dp requested but only one device present; running single-chip" in capsys.readouterr().out
    args.dp = False
    assert COMMON.data_parallel(args, torch.device("cpu")) == (None, torch.device("cpu"))

