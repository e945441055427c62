"""The port's fine-tune tool, ``python -m tpuflow_torch.tools.finetune``,
end to end on the CPU against the JAX package's ``tpuflow.tools.finetune``
at the tiny model of ``tests/test_finetune.py`` (2 scales x 2 steps,
width 8, float32, 4 trajectories of 8 steps, window 4, batch 2).

One source for both: a checkpoint written by the JAX trainer from its
initialization (perturbed, so the zero-init coupling heads and priors
compute something; no epoch is run, which would cost a compile), and its
export to the port's format by ``tools/export_to_torch.py``. The
objective's sample terms are switched off (every lambda 0, no learned
tau), so the draws, which differ by design, cannot move the numbers
compared; the always-on bound stays 0 while the members stay inside
+-8. Then the guard's healthy and impossible budgets of the JAX tool
test, and the output served back through the port's loading.
"""

import csv
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from tpuflow_torch.configs import load_case, parse_cli_overrides
from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow_torch.tools.finetune import LOG_HEADER
from tpuflow_torch.tools.finetune import main as finetune_main
from tpuflow_torch.train import Checkpointer, Trainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASE = "backward-step"
MODEL = ["model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
         "model.coupling_layers=2", "model.growth_rate=4", "model.encoder_width=8",
         "model.lstm_hidden=8", "model.cond_channels=8", "model.hf_shape=16,32",
         "model.lf_shape=4,8", "model.compute_dtype=float32"]
DATA = ["data.n_train_traj=4", "data.n_test_traj=2", "data.train_steps=8", "data.window=4",
        "data.batch_size=2"]
# The JAX tool test's fine-tune (tests/test_finetune.py:326-365).
GUARD = ["finetune.epochs=2", "finetune.n_members=2", "finetune.lambda_disp=0.5",
         "finetune.lr=1e-5", "finetune.train_scope=nets"]


def _args(ckpt_dir, *extra):
    return [CASE, *MODEL, *DATA, f"train.checkpoint_dir={ckpt_dir}", "train.epochs=1",
            "train.checkpoint_every=1", "train.log_every=1000", *extra]


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """(JAX Orbax train.checkpoint_dir, the port's export of it)."""
    import jax
    import jax.numpy as jnp

    from tpuflow.configs.config import load_case as j_load_case
    from tpuflow.models import init_lstm_state as j_init_lstm_state
    from tpuflow.train.trainer import Trainer as JTrainer

    root = tmp_path_factory.mktemp("ft_source")
    cfg = j_load_case(CASE, parse_cli_overrides(_args(root / "jax")[1:]))
    trainer = JTrainer(cfg)
    # The trainer's _fresh_init (model.init on the first real batch), jitted.
    b = cfg.data.batch_size
    lf_b, hf_b = next(trainer.dataset.traj_batches(cfg.data.seed, b))
    variables = jax.device_get(jax.jit(trainer.model.init)(
        jax.random.PRNGKey(cfg.train.seed), jnp.asarray(hf_b[:, 0]), jnp.asarray(lf_b[:, 0]),
        j_init_lstm_state(cfg.model, (b,))))
    rng = np.random.default_rng(5)
    trainer.params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    trainer.buffers = variables["buffers"]
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer.save()
    trainer.ckpt.close()
    spec = importlib.util.spec_from_file_location("export_to_torch",
                                                  ROOT / "tools" / "export_to_torch.py")
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    exporter.export(CASE, root / "jax", root / "port", overrides=parse_cli_overrides(MODEL))
    return root / "jax", root / "port"


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _meta(out):
    return Checkpointer(out / CASE).restore()["meta"]


def test_tool_matches_jax_tool(source, tmp_path, capsys):
    """Two epochs, lambdas 0, learn_tau false: the CSV's loss, bpd,
    grad_norm and skipped_windows against the JAX tool's to 1e-4
    relative, beyond the CSV's printed precision (loss and bpd have 5
    decimals, grad_norm 3, so each side may round one unit of the last
    digit the other way); the header letter for letter; the meta's keys
    (the port's source meta adds the exporter's "source") and the
    finetune summary's keys; the summary line's keys."""
    from tpuflow.tools.finetune import main as j_finetune_main

    jax_dir, port_dir = source
    ft = ["finetune.epochs=2", "finetune.n_members=2", "finetune.learn_tau=false",
          "finetune.lr=1e-3"]
    j_finetune_main(_args(jax_dir, *ft, f"finetune.checkpoint_dir={tmp_path}/jax_ft"))
    capsys.readouterr()
    summary = finetune_main(_args(port_dir, *ft, f"finetune.checkpoint_dir={tmp_path}/ft",
                                  "--device", "cpu"))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary and summary["learned_tau"] is None
    log_j = tmp_path / "jax_ft" / f"{CASE}_finetune_log.csv"
    log_t = tmp_path / "ft" / f"{CASE}_finetune_log.csv"
    assert log_t.read_text().splitlines()[0] == log_j.read_text().splitlines()[0] == LOG_HEADER
    rows_j, rows_t = _rows(log_j), _rows(log_t)
    assert len(rows_t) == len(rows_j) == 2
    for rj, rt in zip(rows_j, rows_t):
        for col, unit in (("loss", 1e-5), ("bpd", 1e-5), ("grad_norm", 1e-3),
                          ("skipped_windows", 0.0)):
            want = float(rj[col])
            assert abs(float(rt[col]) - want) <= 1e-4 * abs(want) + unit, (col, rj, rt)
        assert float(rt["skipped_windows"]) == 0.0
        assert rt["tau"] == rj["tau"]  # tau unlearned: the source's 0.85 on both
    from tpuflow.train.checkpoint import Checkpointer as JCheckpointer

    jck = JCheckpointer(tmp_path / "jax_ft" / CASE)
    meta_j = jck.restore(jck.latest_step(), target=None)["meta"]
    meta_t = _meta(tmp_path / "ft")
    assert set(meta_t) - {"source"} == set(meta_j) and "learned_tau" not in meta_t
    assert set(meta_t["finetune"]) == set(meta_j["finetune"])
    for k in ("epochs", "n_members", "train_scope", "saved_epoch", "epochs_run",
              "early_stopped"):
        assert meta_t["finetune"][k] == meta_j["finetune"][k], k
    np.testing.assert_allclose(meta_t["finetune"]["final_bpd"], meta_j["finetune"]["final_bpd"],
                               rtol=1e-4)
    assert Checkpointer(tmp_path / "ft" / CASE).steps() == [2]
    assert Checkpointer(port_dir / CASE).steps() == [0]  # the source is untouched


def test_tool_guard_matches_jax_tool_test(source, tmp_path):
    """The JAX tool test's two budgets: a healthy run saves its final
    epoch; an impossible skip budget makes every epoch unhealthy, so two
    bad epochs stop the run early (tests/test_finetune.py:326-365)."""
    _, port_dir = source
    finetune_main(_args(port_dir, *GUARD, f"finetune.checkpoint_dir={tmp_path}/ok",
                        "--device", "cpu"))
    ft = _meta(tmp_path / "ok")["finetune"]
    assert (ft["saved_epoch"], ft["early_stopped"], ft["epochs_run"]) == (1, False, 2)
    finetune_main(_args(port_dir, *GUARD, "finetune.epochs=6", "finetune.max_skipped_frac=-1.0",
                        f"finetune.checkpoint_dir={tmp_path}/stop", "--device", "cpu"))
    ft = _meta(tmp_path / "stop")["finetune"]
    assert (ft["early_stopped"], ft["epochs_run"]) == (True, 2)


def test_tool_output_serves_and_resumes(source, tmp_path):
    """The fine-tuned file (default learn_tau) loads through
    load_eval_bundle, resolve_temperature deploys its learned_tau, and
    the port's trainer resumes from it (fresh optimizer state)."""
    _, port_dir = source
    out = tmp_path / "served"
    summary = finetune_main(_args(port_dir, *GUARD, "finetune.lambda_crps=0.3",
                                  "finetune.lambda_spec=0.02", "finetune.lr=1e-3",
                                  f"finetune.checkpoint_dir={out}", "--device", "cpu"))
    tau = summary["learned_tau"]
    assert len(tau) == 2 and all(0.0 < t <= 1.1 for t in tau) and tau != [0.85, 0.85]
    cfg = load_case(CASE, parse_cli_overrides(_args(out)[1:]))
    model, norm, meta = load_eval_bundle(cfg, device="cpu")
    assert norm is not None and meta["learned_tau"] == tau
    np.testing.assert_array_equal(resolve_temperature(cfg, meta, device="cpu").numpy(),
                                  np.asarray(tau, np.float32))
    restored = Checkpointer(out / CASE).restore()
    for k, v in model.state_dict().items():
        assert torch.equal(v, restored["model"][k]), k
    trainer = Trainer(load_case(CASE, {**parse_cli_overrides(_args(out)[1:]),
                                       "train.epochs": 1}), device="cpu")
    trainer.init_or_resume()
    assert trainer.epoch == 0  # the source's meta: the JAX trainer's init
    assert np.isfinite(trainer.run()["mean_bpd"])
