"""Data parallelism of the port (``tpuflow_torch.train.mesh``, the step's
gradient average, the trainer's mesh) against the JAX package's mesh.

``make_mesh`` is held to JAX's ``make_mesh`` on the 8 fake CPU devices of
``tests/conftest.py``: the same axis sizes and the same errors. One test
spawns two worker processes joined over ``gloo`` (they import only torch
and ``tpuflow_torch``; the JAX side runs here and hands its arrays over
in files). In them, at the tiny f32 model of ``tests/test_torch_train.py``:

* one window of the 2-rank step (each rank 2 of the 4 rows) against the
  one-process step on the full batch: loss and every gradient at the
  tolerances of ``test_k2_autograd_matches_jax_grad`` (atol 2e-6 x
  max(1, max|g|), rtol 2e-5); the clip does not fire, so the gradients
  after the step are the averaged ones;
* two windows of the 2-rank trajectory step against JAX's
  ``make_trajectory_train_step`` with the batch data-sharded over
  ``make_mesh(2, 1)``, at the tolerances of
  ``test_trajectory_step_matches_jax`` (bpd 1e-5, mean grad norm 1e-4
  relative), with the parameters equal across the ranks bit for bit;
* the replication check, the trainer's mesh errors inside the group,
  and one epoch of the training CLI under torchrun's environment, where
  rank 0 alone writes the checkpoint and the log.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.configs.config import ModelConfig as JModelConfig
from tpuflow.data import generate_case as j_generate_case
from tpuflow.models import TMGlow as JTMGlow
from tpuflow.models import init_lstm_state as j_init_lstm_state
from tpuflow.train.mesh import data_sharding as j_data_sharding
from tpuflow.train.mesh import make_mesh as j_make_mesh
from tpuflow.train.step import make_optimizer as j_make_optimizer
from tpuflow.train.step import make_trajectory_train_step as j_make_trajectory_train_step
from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.convert import from_flax
from tpuflow_torch.models import TMGlow, init_lstm_state
from tpuflow_torch.train import (
    Trainer,
    data_sharding,
    ensemble_sharding,
    make_mesh,
    make_optimizer,
    shard_batch,
    train_step,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(
    n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
    coupling_width=8, coupling_layers=2, growth_rate=4, encoder_width=8,
    lstm_hidden=8, cond_channels=8, compute_dtype="float32",
)
TINY_ARGS = [f"model.{k}={v}" for k, v in TINY.items() if k not in ("hf_shape", "lf_shape")] + [
    "model.hf_shape=16,32", "model.lf_shape=4,8"]
B, T, WINDOW, LR, CLIP = 4, 4, 2, 5e-4, 100.0


@pytest.mark.parametrize("data,ensemble", [(-1, 1), (-1, 2), (-1, 4), (-1, 8), (2, 2),
                                           (4, 2), (1, 8), (3, 1), (2, 3)])
def test_make_mesh_matches_jax(data, ensemble):
    devices = jax.devices()
    want = j_make_mesh(data, ensemble, devices)
    got = make_mesh(data, ensemble, devices=devices)
    assert (got.data, got.ensemble) == want.devices.shape
    assert list(got.devices) == list(want.devices.reshape(-1))
    assert got.size == want.devices.size


@pytest.mark.parametrize("data,ensemble", [(-1, 3), (0, 1), (3, 3), (9, 1), (2, -1)])
def test_make_mesh_errors_match_jax(data, ensemble):
    devices = jax.devices()
    with pytest.raises(ValueError) as want:
        j_make_mesh(data, ensemble, devices)
    with pytest.raises(ValueError) as got:
        make_mesh(data, ensemble, devices=devices)
    assert str(got.value) == str(want.value)


def test_shardings_and_cpu_mesh():
    """The rows of each rank on a (2, 2) mesh follow JAX's data sharding of
    a batch: ranks of one data index hold the same rows; the members split
    over all four entries."""
    devices = jax.devices()[:4]
    jmesh = j_make_mesh(2, 2, devices)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    placed = jax.device_put(x, j_data_sharding(jmesh))
    mesh = make_mesh(2, 2, devices=list(range(4)))
    for rank, dev in enumerate(jmesh.devices.reshape(-1)):
        (shard,) = [s for s in placed.addressable_shards if s.device == dev]
        np.testing.assert_array_equal(shard_batch(x, mesh, rank), np.asarray(shard.data))
        assert data_sharding(mesh, 8, rank) == shard.index[0]
    assert ensemble_sharding(mesh, 8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not split"):
        data_sharding(mesh, 3, 0)
    with pytest.raises(ValueError, match="does not split"):
        ensemble_sharding(mesh, 6)
    cpu = make_mesh(devices="cpu")
    assert (cpu.data, cpu.ensemble, cpu.devices) == (1, 1, (torch.device("cpu"),))


@pytest.mark.parametrize("override,match", [
    ("train.mesh_data=2", "process group has 1"),
    ("train.mesh_ensemble=2", "not divisible by ensemble=2"),
])
def test_trainer_mesh_errors_on_one_process(override, match):
    cfg = load_case("backward-step", dict(a.split("=") for a in [*TINY_ARGS, override]))
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu")


_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, cli_port, tmp, repo = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                   sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)
torch.set_num_threads(1)
for mod in ("jax", "tpuflow"):
    sys.modules[mod] = None  # the port alone: importing either would fail

from tpuflow_torch.cli.train import main as train_main
from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.models import TMGlow, init_lstm_state
from tpuflow_torch.train import (Trainer, data_sharding, initialize_multihost, make_mesh,
                                 make_optimizer, train_step, trajectory_train_step)

spec = np.load(f"{tmp}/spec.npz")
cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in json.load(open(f"{tmp}/cfg.json")).items()})
state_dict = torch.load(f"{tmp}/weights.pt")
lf, hf = torch.tensor(spec["lf"]), torch.tensor(spec["hf"])
window, lr, clip = int(spec["window"]), float(spec["lr"]), float(spec["clip"])

initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = make_mesh(-1, 1)
assert mesh.devices == (0, 1) and mesh.data == 2
rows = data_sharding(mesh, lf.shape[0])


def fresh():
    model = TMGlow(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return model, *make_optimizer(model.parameters(), lr, 0.995)


model, opt, sched = fresh()
_, m = train_step(model, opt, sched, clip, lf[rows, :window], hf[rows, :window],
                  init_lstm_state(cfg, rows.stop - rows.start, "cpu"))
out = {"bpd": m["bpd"], "grad_norm": m["grad_norm"],
       "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
model, opt, sched = fresh()
mt = trajectory_train_step(model, opt, sched, clip, window, lf[rows], hf[rows])
out.update(traj_bpd=mt["bpd"], traj_grad_norm=mt["grad_norm"],
           params={n: p.detach().clone() for n, p in model.named_parameters()})

# The replication check: agreeing tensors pass, one that differs on rank 1
# raises on both ranks.
from tpuflow_torch.train.mesh import assert_replicated
assert_replicated([torch.ones(3), torch.arange(4.0)])
try:
    assert_replicated([torch.ones(3), torch.arange(4.0) + (rank == 1)])
    out["mismatch"] = None
except RuntimeError as e:
    out["mismatch"] = str(e)

# The trainer's mesh errors inside a group of two.
base = dict(a.split("=", 1) for a in open(f"{tmp}/args.txt").read().split())
errors = []
for extra in ({"train.mesh_data": "1"}, {"data.batch_size": "3"}):
    try:
        Trainer(load_case("backward-step", {**base, **extra}), device="cpu")
    except ValueError as e:
        errors.append(str(e))
out["errors"] = errors
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.destroy_process_group()

# The training CLI under torchrun's environment, one checkpoint directory
# per rank: only rank 0's may be written.
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=cli_port, WORLD_SIZE="2",
                  RANK=str(rank), LOCAL_RANK=str(rank))
final = train_main(["backward-step", *[f"{k}={v}" for k, v in base.items()],
                    f"train.checkpoint_dir={tmp}/ckpt{rank}", "--device", "cpu"])
torch.save(final, f"{tmp}/cli{rank}.pt")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_pair():
    lf, hf = j_generate_case("backward-step", B, T, (16, 32), (4, 8), 5, 3)
    jm = JTMGlow(JModelConfig(conv_layout="nhwc", **TINY))
    v0 = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]),
        j_init_lstm_state(jm.cfg, (B,))))
    rng = np.random.default_rng(3)
    v = {**v0, "params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v0["params"])}
    return jm, v, lf, hf


def test_two_rank_gloo_step_matches_one_process_and_jax(jax_pair, tmp_path):
    jm, v, lf, hf = jax_pair
    tm = TMGlow(ModelConfig(**TINY), device="cpu")
    tm.load_state_dict(from_flax(v, tm))
    torch.save(tm.state_dict(), tmp_path / "weights.pt")
    np.savez(tmp_path / "spec.npz", lf=lf, hf=hf, window=WINDOW, lr=LR, clip=CLIP)
    (tmp_path / "cfg.json").write_text(json.dumps(TINY))
    cli_args = [*TINY_ARGS, "data.n_train_traj=4", "data.train_steps=4", "data.batch_size=4",
                "data.window=2", "train.epochs=1", "train.log_every=1"]
    (tmp_path / "args.txt").write_text(" ".join(cli_args))
    port, cli_port = _free_port(), _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(cli_port), str(tmp_path),
         str(REPO)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    # One window: the 2-rank average against one process on the full batch.
    model = TMGlow(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(tm.state_dict())
    opt, sched = make_optimizer(model.parameters(), LR, 0.995)
    _, m = train_step(model, opt, sched, CLIP, torch.tensor(lf[:, :WINDOW]),
                      torch.tensor(hf[:, :WINDOW]), init_lstm_state(model.cfg, B, "cpu"))
    assert float(m["grad_norm"]) < CLIP  # no clip: p.grad is the averaged gradient
    for got in ranks:
        np.testing.assert_allclose(got["bpd"].item(), m["bpd"].item(), rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), m["grad_norm"].item(), rtol=2e-5)
        for n, p in model.named_parameters():
            want = p.grad.numpy()
            np.testing.assert_allclose(got["grads"][n].numpy(), want, rtol=2e-5,
                                       atol=2e-6 * max(1.0, np.abs(want).max()), err_msg=n)

    # Two windows: JAX's trajectory step with the batch data-sharded over
    # make_mesh(2, 1).
    jmesh = j_make_mesh(2, 1)
    tx = j_make_optimizer(LR, 0.995, CLIP)
    step = jax.jit(j_make_trajectory_train_step(jm, tx, window=WINDOW))
    ds = j_data_sharding(jmesh)
    _, _, m_j = step(v["params"], v["buffers"], tx.init(v["params"]),
                     jax.device_put(lf, ds), jax.device_put(hf, ds))
    for got in ranks:
        np.testing.assert_allclose(got["traj_bpd"].numpy(), np.asarray(m_j["bpd_per_window"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["traj_grad_norm"].mean().item(),
                                   float(m_j["grad_norm"]), rtol=1e-4)
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n

    # The replication check and the trainer's mesh errors inside the group.
    for got in ranks:
        assert "1 of 2 tensors, first at index 1" in got["mismatch"]
        assert "process group has 2" in got["errors"][0]
        assert "data.batch_size=3" in got["errors"][1] and "data size 2" in got["errors"][1]

    # The CLI: both ranks report the same global epoch; rank 0 alone wrote.
    finals = [torch.load(tmp_path / f"cli{r}.pt") for r in range(2)]
    assert finals[0]["epoch"] == finals[1]["epoch"] == 1
    assert finals[0]["mean_bpd"] == finals[1]["mean_bpd"] and np.isfinite(finals[0]["mean_bpd"])
    written = [sorted(p.name for p in (tmp_path / f"ckpt{r}" / "backward-step").glob("*"))
               if (tmp_path / f"ckpt{r}" / "backward-step").exists() else [] for r in range(2)]
    assert "train_log.csv" in written[0] and any(n.startswith("ckpt_") for n in written[0])
    assert written[1] == []
    rows = (tmp_path / "ckpt0" / "backward-step" / "train_log.csv").read_text().splitlines()
    assert len(rows) == 1 + 2  # the header and two windows
    assert json.dumps(finals[0])  # plain numbers
